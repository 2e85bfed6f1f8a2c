#!/usr/bin/env python3
"""Smoke run of the PyTorch port (horovod_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card and nvcc (CUDA_HOME or /usr/local/cuda).
Phases, one JSON line each:

1. device  — the card's name and power limit (nvidia-smi);
2. build   — nvcc builds every CUDA kernel source of the package;
3. kernel  — each hand-written kernel against its plain PyTorch version
   on the card, at the shapes ResNet-50 at batch 64 gives it, with its
   time, the plain version's, the least time the card could take
   (bound) and one PyTorch library call's (timed only, never used by
   the port): the conv kernels (#3, #4) at the 9 shapes of the 26 fused
   convs, timed on the device alone beside torch.matmul timed the same
   way, with the host's enqueue, s1/s2 bit-identical across calls
   (kernel_total lines: sums over the 26 convs, with registers and
   spills); the optimizer kernels (#1, #2) as the train step calls
   them, one FusedAdam / FusedSGD step over the 161 leaves, held
   bit-identical to use_kernels=False, with the step's device and host
   times;
4. train   — full-width ResNet-50 (1000 classes, 224x224, bf16 compute,
   f32 params, batch 64) in an NCCL world of one, broadcast_parameters,
   HVDT_FUSED_CONV1X1=1, DistributedOptimizer(fused_sgd(0.01, momentum
   0.9)), 3 steps: the fused conv-stats kernel must launch 26 times a
   step and the SGD kernel every step;
5. eval    — one eval forward through the fused conv+affine kernel (26
   launches), held against the unfused forward on the same card;
6. adam    — 2 steps with DistributedOptimizer(fused_adam(1e-3));
7. quant_kernel — the four int8/int4 quantize/dequantize kernels against
   their plain versions on the card at each fused-bucket size of the
   ResNet-50 gradients (64 MiB threshold, padded to whole 256-element
   blocks): payload, scales and dequantized values bit-identical; each
   timed on the device alone, by the host's enqueue and back to back
   (quant_kernel_total lines: sums over the buckets);
8. int8    — 3 train steps under quant.with_error_feedback(
   DistributedOptimizer(fused_sgd(...), compression=Compression.int8)):
   the int8 quantize/dequantize kernels launch exactly as often as the
   leaf count and the bucket plan say, and one exchange of the same
   gradients gives the same bytes with HVDT_QUANT_KERNELS=off; then the
   step time against the uncompressed wire in turns, and host times of
   error feedback and of one exchange over each wire;
9. int4    — 2 steps with compression left unset and HVDT_COMPRESSION=
   int4 (Compression.from_env), with_error_feedback(..., wire="int4");
10. eager  — the reference's eager core (ops/eager.py) in the NCCL world
   of one: examples/jax_imagenet_resnet50.py's loop through the port's
   top level at full width (ResNet-50, batch 64, bf16 compute, f32
   params, HVDT_FUSED_CONV1X1=1): broadcast_parameters, hvd.broadcast of
   the start epoch, 3 steps of DistributedOptimizer(fused_sgd(0.01,
   momentum 0.9)) with hvd.allreduce(loss, name="avg_loss") each step
   (#4 26 launches a step, #2 one); every eager op on CUDA tensors of
   f32, bf16, fp16, int32 and int64 (allreduce with each reduce op and
   with pre/post scale, grouped allreduce, ragged allgather, broadcast,
   alltoall with splits, reducescatter, barrier, join,
   allgather_object, sparse_allreduce) bit-identical to the world-of-one
   answer, on the input's device and dtype, the producer-stream case (an
   input still being computed on a side stream) and a numpy input;
   eager_grouped, a grouped_allreduce of ResNet-50's 161 gradient leaves
   (its fused responses and bytes) bit-identical to
   device.fused_allreduce, with the host ms of one call of each;
   eager_costs, one small allreduce's host ms from enqueue to
   synchronize and the controller's idle cycles and store round trips a
   second; eager_capture, a donated_step capture taken while eager ops
   are in flight, replayed bit-identically to the eager step;
10b. sync_bn — SyncBatchNorm on the main path: the bs-64 ResNet-50 step
   with bn_axis="dp", HVDT_FUSED_CONV1X1=1 (#4 under axis=) and
   DistributedOptimizer(fused_sgd) (#2), graphed by donated_step:
   losses, parameters, BN statistics and momentum bit-identical to the
   eager step and to bn_axis=None (a world of one), #4 26 times and #2
   once a replay (torch.profiler), the step's ms against bn_axis=None's
   in turns;
10c. accumulate — backward_passes_per_step k = 2 and 4 under
   donated_step (one graph a pass of the cycle) against the eager
   passes, bit for bit, on the bs-64 batch cut into k micro-batches; the
   kernels of each pass's replay (no NCCL kernel and no #2 on a
   non-boundary pass); microbatch_gradients with k = 4 against the
   gradients one k = 4 accumulation hands the optimizer, bit for bit;
10d. wire_graphed — the int8 and int4 wires under with_error_feedback(
   DistributedOptimizer(...)) graphed against eager over 3 steps
   (parameters, momentum and residuals bit-identical), #5-#8 launches a
   replay against the leaf count and the bucket plan, the graphed step's
   ms against the eager step's in turns;
10e. vgg, mlp — VGG-16 (configuration D, 224x224, 1000 classes, bf16
   compute, f32 params, batch 64, 138.4M parameters) under
   DistributedOptimizer(fused_sgd(1e-3)), 3 graphed steps, then its step
   ms, img/s and MFU (FlopCounterMode); the MLP (784-256-128-10, batch
   64), 3 graphed steps and its step ms;
10f. overlap — HVDT_OVERLAP=on at 8 MiB buckets (ops/overlap.py): the
   bs-64 ResNet-50 step graphed (hooks issue each bucket on a
   communication stream during the backward) against the monolithic
   graphed step, bit for bit (a world of one's sum is a copy), with the
   bucket count and overlap_fraction; pipelined_sgd graphed against the
   monolithic step, bit for bit, #2 once a bucket a replay; the int8
   and int4 wires with error feedback overlapped, graphed against
   eager, #5-#8 a replay against the overlap plan; the step's ms with
   and without overlap, in turns;
10g. zero — ZeRO (ops/zero.py) in the world of one, where the layout is
   unbound (one shard, no collective): the bs-64 ResNet-50 step graphed
   under DistributedOptimizer(zero=grads|states|params) with fused_sgd
   and fused_adam(1e-3, weight_decay=1e-4) against the replicated
   graphed step, parameters, BN statistics and moments bit for bit;
   #2 or #1 once a replay; each step's ms against the replicated one's
   in turns;
10h. ckpt — checkpoint.py: the zero=states Adam step graphed; the model
   state (CheckpointManager) and the ZeRO state (save_zero_state)
   saved, the stall of save and of save_async timed, the async snapshot
   restored to its values although the next replay updated the tensors
   in place; then restored in place into the captured step, whose
   replays continue bit for bit as an uninterrupted run;
10i. autotune — autotune.autotuned_step with HVDT_AUTOTUNE=1 over the
   bucket, overlap and ZeRO dimensions (4 samples; each knob change a
   fresh capture over the same optimizer and state): samples, rebuilds,
   final knobs, and the tuned run's state equal to an untuned run's;
10j. interop — Horovod's torch API (horovod_tpu_torch.interop.torch) on
   ResNet-50 at 224x224, batch 128, bf16 compute, f32 params,
   HVDT_FUSED_CONV1X1=1, deterministic cuDNN: interop, 3 steps of
   interop.torch.DistributedOptimizer(fused_sgd(0.01, momentum 0.9),
   named_parameters=...) (161 gradient hooks, each a named async
   allreduce on the eager controller), held bit for bit against the
   port's own DistributedOptimizer(fused_sgd) on the same batches (#2 once
   a step), then both timed in turns with the host ms in the hooks and in
   synchronize() a step beside the fused exchange's; interop_int8, 3 steps
   with fused_adam and compression=Compression.int8 (#5 and #6 once a
   float leaf a step in the hooks, #1 once a step), one step's reduced
   leaves against the plain quantize-dequantize bit for bit;
   interop_sync_bn, the interop SyncBatchNorm (plain _BatchNorm in a
   world of one, bit for bit with nn.BatchNorm2d) and its synchronized
   function (named eager allreduces of f64 statistics on the card)
   against F.batch_norm at [128, 256, 56, 56] in f32 and bf16;
   interop_timeline, 3 interop steps with HVDT_TIMELINE set: every
   grad.<name> row of the JSON holds NEGOTIATE_ALLREDUCE then
   EXEC_ALLREDUCE each step;
11. flash_kernel — the three flash-attention kernels (#9 forward, #10
   dQ, #11 dK/dV) against their plain versions at the LM path's shape
   (B 16, H 16, L 4096, D 64, bf16, causal), with
   scaled_dot_product_attention's forward and backward as the library
   yardstick, each line with its fraction of the bound and the kernel's
   registers and spills from the build log (#11's line adds pair_ms,
   #10 + #11, and pair_over_library, the pair over SDPA's backward);
   then one GQA case (Hkv 4), one offset case of flash_block_update, and
   a ragged one (L 1000, Hkv 4, offsets and a carry, the rows that see no
   key passed through bit for bit; then flash_grad_block at the same
   offsets against the plain versions of #10 and #11);
12. ring    — ring attention (horovod_tpu_torch.parallel) at the LM
   path's attention width (H 16, D 64, bf16): ring_entry, the entry
   point in the NCCL world of one at the lm_train shape (B 16, L 4096),
   forward and backward with use_pallas=True, against flash_attention
   with the kernel backward (#9 launches once, #10 and #11 once each),
   then the plain step (use_pallas=False, no kernel launch) at B 1
   against the kernel step; ring_virtual, every member of a ring of 4
   (shard 4096, batch 4, global L 16384) through the ring module's step
   functions, the rotation done by indexing the shard list, against
   whole-sequence flash_attention (causal: #9, #10 and #11 launch 10
   times each; not causal: 16), then the same ring of 4 at B 1 with the
   plain step (no kernel launch) against the kernel ring; ring_step, the device-alone time of one
   fully visible and one diagonal step beside their bounds, and the
   summed ring of 4 against the whole-sequence kernels (the transfers
   are not timed: one card has no peer);
13. lm_train — the bert-large transformer LM preset at full width and
   depth (24 x 1024, 16 heads, d_ff 4096, vocab 30528, bf16 compute, f32
   params, remat full, loss_chunk 8192) at seq 4096, batch 16, through
   init, broadcast_parameters and DistributedOptimizer(fused_adam(3e-4,
   weight_decay=1e-4)), HVDT_FLASH_ATTENTION unset (the auto gate must
   engage) and HVDT_FLASH_BWD=kernel, 3 steps: per step #9 launches 48
   times (forward and remat recompute), #10 and #11 24 times each;
14. lm_bwd_default — 2 steps with HVDT_FLASH_BWD unset (the plain
   blockwise backward); the first step's gradients are held against the
   kernel backward's from the same state;
15. smallseq_kernel — the two whole-sequence kernels (#12 forward, #13
   backward, two launches a call) against their plain versions at the
   seq-512 LM path's shape (B 128, H 16, L 512, D 64, bf16, causal), each
   timed on the device alone and back to back beside
   scaled_dot_product_attention's forward and backward timed the same
   ways (fraction of the bound, registers and spills of each CUDA kernel;
   #13's line adds its design's byte floor and, from torch.profiler, its
   launches a call and each one's device time); then GQA (Hkv 4), D 128,
   non-causal, fp16 and ragged (L 200) cases;
16. lm_smallseq — the same bert-large preset at seq 512, batch 128, full
   width and depth, HVDT_FLASH_SMALLSEQ=on (HVDT_FLASH_ATTENTION and
   HVDT_FLASH_SMALLSEQ_HB unset), fused_adam(3e-4, weight_decay=1e-4), 3
   steps: per step #12 launches 48 times (forward and remat recompute),
   #13 24 times and #9-#11 never (and in every train phase the optimizer
   kernel exactly once a step);
17. lm_smallseq_default — 2 steps with HVDT_FLASH_SMALLSEQ unset (the
   materialized-score attention: 2.1 GB of f32 scores stays under the 4
   GiB flash gate); the first step's gradients are held against the
   smallseq path's from the same state, and no attention kernel runs;
16b. lm_tp1 — the bert-large preset at seq 512, batch 32, built through
   the sharding rules (transformer_init with tp_rank / fsdp_rank) and
   run with tp_group and fsdp_group of one (a mesh dp 1 x fsdp 1 x tp
   1), HVDT_FLASH_SMALLSEQ=on: its parameters, one step's loss and every
   gradient equal the dense model's in every byte; #12 48 / #13 24 /
   #1 1 in the step under DistributedOptimizer(fused_adam, axis="dp");
17b. fp8 — quant/fp8.py on the card: the e4m3 operands bit for bit
   against the plain version's (CPU), fp8_matmul (torch._scaled_mm)
   against the plain product and its straight-through backward against
   the plain f32 formula, times of _scaled_mm, fp8_matmul and the bf16
   torch.matmul at M 65536, K 1024, N 4096; the bert-large LM at seq
   512, batch 128 with HVDT_FP8=matmul and off in turns (finite losses,
   tokens/s each; #12/#13 as in lm_smallseq), then one profiled step of
   each (device ms by kernel class, top kernels);
17c. moe_dispatch — parallel.moe_dispatch_combine in a group of one at
   one bert-large MoE layer's shape (T 32 x 512, d 1024, f 4096, 8
   experts, capacity factor 1.25, bf16, f32 router logits), top_k 1 and
   2, each row against a float64 reference of the same routing within
   2^-6, with its time back to back, on the device alone and enqueued,
   the expert products' time, the dropped fraction and each
   all-to-all's bytes; then HVDT_TRANSPORT=ep:ring:int8:64M: #5 and #6
   4 times each in a forward and backward, within 2e-2 of the exact
   wire;
17d. lm_moe — the bert-large preset with num_experts=2 at ep=1 (the
   dense fallback), seq 512, batch 32, HVDT_FLASH_SMALLSEQ=on, fused
   Adam, 3 steps: losses finite and falling, tokens/s, peak memory,
   #12 48 / #13 24 / #1 1 a step;
17e. lm_dots — the bert-large preset (dense) at seq 512, batch 128:
   remat_policy="dots" against "full", the gradients from one state
   (equal in every byte, or their distance), 2 steps of each in turns
   (full, dots, dots, full) with step seconds, peak memory and #12
   launches, and the aten.mm the backward runs at batch 4 under none,
   full and dots (0 recomputed under dots);
18. bench — the port's bench leg (horovod_tpu_torch.bench, ResNet-50 at
   224x224, batch 128, bf16 compute, f32 params, 3 iterations of 20
   steps each) in turns: G (--fused-optimizer, HVDT_FUSED_CONV1X1=1,
   the step captured as one CUDA graph by donated_step), E (the same
   step eagerly), E, G, D (the default leg: torch.optim.SGD, unfused
   convs, graphed), R (--remat dots: D with the loss checkpointed), each with img/s, MFU, the per-iteration rates and
   their spread, compile_s and peak memory; torch.profiler over 5 steady
   steps of G and of E (the device's busy and idle share, the top
   kernels; a graphed step must launch #4 26 times and #2 once, counted
   by kernel name); #4 against its plain version at the 9 shapes of the
   leg's 26 fused convs (batch 128), as in phase 2; then 3 graphed
   against 3 eager steps of two copies
   from one state under DistributedOptimizer in the NCCL world of one,
   with fused_sgd and then fused_adam and deterministic cuDNN: losses,
   parameters, BN statistics and optimizer state bit-identical; the
   bench line adds the default leg's img/s beside PR 13's recorded one
   (PR13_LEG_D_IMG_S, a constant) and the chaos-audit mode, leg D for 20 steps with
   HVDT_FAULT_PLAN=exc@step=5,exc@step=15: the JSON's recovered_faults
   and injected_faults are 2;
18b. elastic — the runtime plane's in-process retry loop in the NCCL
   world of one: ResNet-50 (224x224, bf16 compute, f32 params, batch 64,
   HVDT_FUSED_CONV1X1=1, deterministic cuDNN) through
   interop.torch.DistributedOptimizer(fused_sgd(0.01, momentum 0.9))
   under hvd.elastic.run with TorchState(model, optimizer,
   sampler=ElasticSampler, batch), a commit every 5 steps, 20 steps;
   then again with HVDT_FAULT_PLAN=exc@step=12 (the step loop fires the
   point before each step): restore of the batch-10 commit, _reset
   (shutdown + init), sync, steps 11-20 again.  Final parameters and BN
   statistics equal the uninterrupted run's in every byte; #2 launches
   21 times (#4 26 a step); the recovery's ms (restore, re-init,
   re-sync, first step);
18c. elastic_launch — the port's launcher on this card: python -m
   horovod_tpu_torch.runner.launch with a discovery script printing
   localhost:1, --fault-plan crash@step=12, --blacklist-cooldown 1 and a
   disk state path, running this script's --elastic-worker: the worker
   dies before step 12, the driver respawns the generation, the new
   process resumes from the batch-10 commit, and its final parameters
   and BN statistics equal 18b's uninterrupted run's in every byte; the
   restart's ms split into detection and respawn, imports, init(),
   building the model and data, the resume and the first step;
19. optim_lm — #1 as the LM steps call it, one FusedAdam(3e-4,
   weight_decay=1e-4) step over clones of the bert-large leaves (11
   leaves, 434.0M parameters), held bit-identical to the plain version,
   beside torch.optim.AdamW(fused=True);
20. summary — total wall time, then the kernels line (13 kernels).

Any failure raises and the script exits non-zero without the last line,
which is exactly {"ok": true, "device": {...}} on success.  Without a
card, or run from a directory without the package, it exits non-zero.

    python3 chip_smoke.py --ring-cards 4

runs ring attention across 4 cards instead (one process a card, an NCCL
world, the mesh's sp dimension): ring_cards, the ring at the ring phase's
shape against whole-sequence flash_attention (causal and not, the
launches of each rank) and the plain step against the kernel step;
ring_cards_time, the ring's forward and backward beside the same kernel
steps without transfers and a bare rotation; ring_cards_lm, the
bert-large preset with sp = 4 at global seq 16384, batch 4: its hidden
states against the whole sequence on one card, and 3 training steps
(the ring's default on bf16 operands on the card: kernels #9-#11);
ring_cards_graphed, that step under donated_step (the ring's NCCL P2P
transfers captured) against it eagerly: losses, gradients and
parameters after 3 calls in every byte, the kernels of one replay
(torch.profiler) against one eager step's launches, step seconds in
turns and peak memory.

    python3 chip_smoke.py --eager-cards 4

runs the eager core across 4 cards (one process a card, an NCCL world;
no kernel is built): eager_cards, every eager op of every dtype above
issued in a different order on each rank and held against numpy's
answer (exact for integers, MIN/MAX and moves; a float sum within its
dtype's rounding of the summands), a rank that joins at once while the
others reduce (it adds each reduction's identity), allgather_object,
one named uneven alltoall called three times; eager_cards_grouped, the 161-leaf grouped allreduce against
device.fused_allreduce (its fused responses, host ms of each), one small
allreduce's host ms, and each rank's idle cycles a second and store
round trips a cycle; eager_cards_adasum, hvd.allreduce(op=hvd.Adasum) of
an f32 and a bf16 vector against the host tree over every rank's.

    python3 chip_smoke.py --dp-cards 4

runs the data-parallel step across 4 cards (one process a card, an NCCL
world, the eager controller never started), after the one-card bench
leg G on card 0 (bench_leg line, the yardstick of the scaling):
dp_cards, ResNet-50 with bn_axis="dp", fused convs (#4) and
DistributedOptimizer(fused_sgd) (#2), graphed, at batch 32 a card:
state bit-identical on every rank after 3 steps, and the first step in
f32 (unfused) against one card running the global batch of 128 with
bn_axis=None, with the reordered global batch as the yardstick, and
each distinct fused 1x1 conv + BN of that model (#4 under axis="dp")
against the same op on the global batch, rank by rank, with the op's
per-rank statistics as the yardstick;
dp_cards_time, batch 128 a card: the step with the exchange and the
SyncBN collectives, with one of them, and with neither, graphed; img/s
a card and the scaling efficiency against leg G; dp_cards_wire, the
int8 and int4 wires graphed against eager on every rank, with the bytes
each rank sends; dp_cards_vgg, VGG-16 at batch 64 a card over the exact
and the int8 wire: step ms and one exchange's ms (553 MB of f32
gradients); dp_cards_accumulate, k = 2 (no SyncBN: the exchange is
the only collective) graphed against eager, NCCL kernels only on the
boundary pass; dp_cards_overlap, batch 128 a card with HVDT_OVERLAP=on
at 8 MiB buckets: state identical on every rank, one exchange's
gradients against the monolithic exchange's (relative L2), the graphed
step with and without overlap in turns and overlap_fraction;
dp_cards_adasum, one Adasum exchange of ResNet-50's gradients against
the host tree per bucket; dp_cards_transport, on a 2x2 ("dcn", "ici")
mesh, hierarchical f32 and the int8 slow tier against the flat exchange,
bytes a rank sends on each tier and each exchange's ms; dp_cards_zero,
batch 128 a card, SyncBN, fused_adam: ZeRO grads, states and params
graphed against the replicated step (gradients and state by relative
L2, identical on every rank), the optimizer state's bytes a rank
planned and by memory_allocated against the replicated 204.5 MB, each
stage's step ms against the replicated in turns, states with the int8
wire, error feedback and HVDT_OVERLAP=on (#5/#6 and #1 a replay), and
the 4-shard state saved and restored as 2 and as 4 shards;
dp_cards_missing_grad, parameters a, b, c under SGD with a gradient for
b on rank 0 only, on every exchange path (default, k = 2, HVDT_OVERLAP,
ZeRO grads/states/params with and without overlap, the interop
optimizer): the zero-filled average, exactly, on every rank;
dp_cards_interop, ResNet-50 (f32, bn_axis="dp", batch 32 a card) under
interop.torch.DistributedOptimizer(fused_sgd): its 161 named
allreduces against one card running the global batch and against the
fused exchange, #2 once; dp_cards_interop_sync_bn, the interop
SyncBatchNorm with ragged batches against BatchNorm over the whole
batch in f64; dp_cards_bench_allreduce, python -m
horovod_tpu_torch.bench_allreduce's modes in this world at 1 to 64 MiB
(the flat sweep on every wire and the eager path, --reduce-scatter,
--a2a, --hierarchical on a 2x2 mesh), one line a mode.  Every dp line
carries its phase's wall_s.

    python3 chip_smoke.py --parallel-cards 4

runs the parallel axes across exactly 4 cards (one process a card, an
NCCL world): par_cards_moe, bert-large with ep = 4 and 8 experts (2 a
rank), seq 512, batch 32 a card, DistributedOptimizer(fused_adam,
axis="dp", expert="ep"): at capacity factor 8 (no drops) one step's
loss and gradients against one card running the global batch with
moe_dispatch_combine in a group of one, then 3 steps at 1.25 (step
seconds, tokens/s a card, one all-to-all's ms and bytes, each layer's
dropped fraction); par_cards_moe_int8, the int8 ep wire (loss within 5%
of the exact wire's, #5/#6 144 each a step); par_cards_pp, bert-large
with pp = 4 (6 layers a stage, m = 4, batch 128): one step against one
card running 24 layers, 3 steps, #12/#13, the priced bubble 3/7 against
the observed one; par_cards_4d, the reference's 4D battery at pp 2 x ep
2 (f32, 5 SGD steps within rtol 2e-4 of the dense reference); then the
phases over tp, fsdp and sp, bert-large at seq 512 (24 layers, d 1024,
16 heads of 64, d_ff 4096, bf16, remat, HVDT_FLASH_SMALLSEQ=on) unless stated
otherwise, each under DistributedOptimizer(fused_adam, axis="dp") and
each held against one card (rank 0, the same seed) at the same loss
and gradient bounds, every replicated leaf's gradient equal on every
card: par_cards_tp, tp = 4 with the same 32 rows on every card (#12/#13
on 4 local heads): one step, then 3 steps with step seconds, tokens/s
and the tp all-reduces and all-gathers a step (bytes, and the device ms
of one activation all-reduce); par_cards_fsdp, fsdp = 4 at 32 rows a
card against the global batch of 128: parameter and Adam-state bytes a
card against replicated, peak memory, 3 steps; par_cards_dp2_tp2, dp 2
x tp 2 at 32 rows a dp member: 3 steps' losses, the first step's
gradients and the parameters after 3 steps against one card running
batch 64; par_cards_sp_dp, dp 2 x sp 2 at global seq 4096,
HVDT_RING_PALLAS=1 (#9-#11 in every ring step), the members' loss
(each shard's own targets) against one card's whole sequence, 3 steps
with the ring's launches; par_cards_sp_pp, pp 2 x sp 2, the ring inside
each pipeline stage, one step against one card; par_cards_graphed_sp_dp
and _pp, par_cards_sp_dp's and par_cards_pp's steps under donated_step
against them eagerly, as ring_cards_graphed; par_cards_tp_ep, tp 2 x ep
2 with 8 experts at 32 rows an ep member: one step against one card (in
f32 loss and gradients, in bf16 the loss), 3 steps, and
par_cards_tp_ep_graphed.  Each phase runs under a
watchdog that names it if it hangs.  Then the bench's --moe and
--pipeline sweeps with their autotune seeds.

    python3 chip_smoke.py --elastic-cards 4

runs the port's launcher with --elastic across 4 cards (one worker
process a card, an NCCL world made afresh each generation; ResNet-50 at
batch 64 a card under the port's DistributedOptimizer(fused_sgd), whose
fixed buckets keep NCCL's reduction order from run to run): an
uninterrupted 20-step run of 4 slots; elastic_cards_crash, the same
with crash@step=10:rank=3 and a 1 s blacklist cooldown (the driver
terminates the survivors, respawns the world of 4, which resumes from
the batch-5 commit), its final parameters and BN statistics against the
uninterrupted run's, and the restart's ms; elastic_cards_shrink,
localhost:4 then localhost:2 once batch 7 is logged, and
elastic_cards_grow, localhost:2 then localhost:4, each holding the
reference's log contract (the new world resumes past batch 1, every
rank of it logs, the LR is 0.01 x the world size, batch 30 is reached)
with the recovery's ms.  Each scenario runs under a watchdog that names
it if it hangs.  The multi-card modes end with the card's line and the
last line of the one-card run.
"""

import gc
import json
import math
import os
import shutil
import subprocess
import sys
import time

# When this process started (an elastic worker's restart is split from
# here), before the imports below.
_T_START = time.time()

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

# Published peaks of one H100 SXM (dense): bf16 tensor cores and HBM.
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
BATCH, IMAGE = 64, 224


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters: int = 10, reps: int = 5, warmup: int = 3) -> float:
    """Time of one call of ``fn`` by CUDA events: the median over
    ``reps`` runs of the mean over ``iters`` back-to-back calls (one
    stray slow call moves a mean, not the median)."""
    return cuda_ms_stats(fn, iters, reps, warmup)["median"]


def _stats(times):
    times = sorted(times)
    return {"median": times[len(times) // 2], "min": times[0],
            "max": times[-1]}


def cuda_ms_stats(fn, iters: int = 10, reps: int = 5,
                  warmup: int = 3) -> dict:
    """:func:`cuda_ms` with the min and max of the reps beside the
    median."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return _stats(times)


def host_ms(fn, reps: int = 5) -> float:
    """Median host-clock time of ``fn`` in ms, each call ended by a
    synchronize (for work that is many small launches)."""
    times = []
    for _ in range(reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times[1:])[reps // 2]


def device_ms_stats(fn, iters: int = 10, reps: int = 5,
                    sleep_cycles: int = 20_000_000) -> dict:
    """Device time of one call of ``fn``: ``iters`` calls queued behind a
    device sleep of ``sleep_cycles`` clocks (~10 ms), long enough for the
    host to enqueue them all, so the events time the device alone and
    not the host's enqueue.  Median, min and max over ``reps``."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep_cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return _stats(times)


def enqueue_ms_stats(fn, reps: int = 21) -> dict:
    """Host-clock time of one call of ``fn`` from an idle queue to its
    return, without waiting for the device: what the host spends to
    enqueue it."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return _stats(times)


def bound(nbytes: float, flops: float, peak_flops: float):
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / peak_flops * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def fused_conv_shapes(batch: int, image: int):
    """(M, K, N) → count of the fused 1x1 convs in one ResNet-50 forward
    (the layers models/resnet._fused_1x1_eligible selects)."""
    from horovod_tpu_torch.models.resnet import _STAGES

    shapes = {}
    hw = image // 4                      # after the stem and the max pool
    cin = 64
    for si, (blocks, mid) in enumerate(_STAGES[50]):
        for bi in range(blocks):
            stride = 2 if (bi == 0 and si > 0) else 1
            out_hw = hw // stride
            for m, k, n in ((batch * hw * hw, cin, mid),          # conv1
                            (batch * out_hw * out_hw, mid, mid * 4)):  # conv3
                if k % 128 == 0 and n % 128 == 0:
                    shapes[(m, k, n)] = shapes.get((m, k, n), 0) + 1
            hw, cin = out_hw, mid * 4
    return shapes


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})
    return smi


def ptxas_of(log: str, entry: str) -> dict:
    """Registers and spill bytes of the kernel whose mangled entry name
    contains ``entry``, from a build log (``nvcc -Xptxas -v``)."""
    found, out = False, {}
    for line in log.splitlines():
        if "Compiling entry function" in line:
            found = entry in line
        elif found and "spill stores" in line:
            words = line.split()
            out["spill_store_bytes"] = int(words[words.index("spill") - 2])
            out["spill_load_bytes"] = int(words[-4])
        elif found and "registers" in line:
            words = line.split()
            out["registers"] = int(words[words.index("registers,") - 1]
                                   if "registers," in words else
                                   words[words.index("registers") - 1])
            found = False
    return out


def kernel_ptxas(name: str) -> list:
    """:func:`ptxas_of` each CUDA kernel of TPU kernel ``name`` (bf16, D 64
    for the attention kernels, the LM paths') in its library's last build
    log, one dict a CUDA kernel with its entry under ``kernel``."""
    from horovod_tpu_torch import _build

    lib, entries = KERNEL_ENTRY[name]
    log = _build.build_log(lib) or ""
    return [dict(kernel=entry, **ptxas_of(log, entry)) for entry in entries]


# TPU kernel -> (library, the mangled-name parts of its CUDA kernels).
KERNEL_ENTRY = {
    "_mm_kernel": ("conv_fused", ["mm_bn_relu_kernelI13__nv_bfloat16"]),
    "_mm_stats_kernel": ("conv_fused", ["mm_stats_kernelI13__nv_bfloat16"]),
    "_kernel": ("flash_attn", ["flash_fwd_kernelI13__nv_bfloat16Li64E"]),
    "_dq_kernel": ("flash_attn", ["flash_dq_kernelI13__nv_bfloat16Li64E"]),
    "_dkv_kernel": ("flash_attn", ["flash_dkv_kernelI13__nv_bfloat16Li64E"]),
    "_smallseq_fwd_kernel": ("flash_smallseq",
                             ["smallseq_fwd_kernelI13__nv_bfloat16Li64E"]),
    "_smallseq_bwd_kernel": ("flash_smallseq",
                             ["smallseq_dq_kernelI13__nv_bfloat16Li64E",
                              "smallseq_dkv_kernelI13__nv_bfloat16Li64E"]),
}


def phase_build():
    from horovod_tpu_torch import _build

    t0 = time.time()
    paths = _build.build_all()
    ptxas = []   # each kernel's registers and spills, under its entry name
    for name in paths:
        entry = None
        for line in (_build.build_log(name) or "").splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1]
            elif "registers" in line or "spill" in line:
                ptxas.append(f"{entry}: {line.strip()}")
    emit({"phase": "build", "seconds": round(time.time() - t0, 3),
          "libraries": [str(p.name) for p in paths.values()],
          "ptxas": ptxas})


def conv_times(kernel, plain, library) -> dict:
    """One conv kernel's times at one shape: the device alone (CUDA events
    behind a device sleep; median, min, max) beside ``library`` timed the
    same way, the host's enqueue of one call, the back-to-back figure
    (CUDA events over calls queued as the host makes them, which the host
    bounds when its enqueue is the longer) and the plain version's."""
    dev = device_ms_stats(kernel, iters=20)
    lib = device_ms_stats(library, iters=20)
    host = enqueue_ms_stats(kernel)
    return {"kernel_ms": dev["median"], "kernel_ms_min": dev["min"],
            "kernel_ms_max": dev["max"], "library_ms": lib["median"],
            "library_ms_min": lib["min"], "library_ms_max": lib["max"],
            "enqueue_ms": host["median"], "back_to_back_ms": cuda_ms(kernel),
            "plain_ms": cuda_ms(plain)}


def conv_operands(gen, m, k, n):
    """Random bf16 operands of one fused 1x1 conv: a [M, K] and w [K, N],
    as the model hands the kernels w = (OIHW weight viewed [N, K]).t()."""
    dev = torch.device("cuda")
    a = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
    w = (torch.randn((n, k), generator=gen, device=dev)
         / math.sqrt(k)).to(torch.bfloat16).t()
    return a, w


def check_mm_stats(cf, a, w):
    """#4 against its plain version on one (a, w): z within one bf16 ulp
    of the largest output (both round an f32 sum that differs only in
    summation order), the partial sums of z and z^2 within 1e-4 of the
    largest (128 f32 values, differently associated), and z, s1, s2
    bit-identical across two calls.  Returns z's error and tolerance."""
    shape = (*a.shape, w.shape[1])
    z, s1, s2 = cf.matmul_batch_stats(a, w)
    z_ref, s1_ref, s2_ref = cf._mm_stats_plain(a, w)
    again = cf.matmul_batch_stats(a, w)
    torch.cuda.synchronize()
    assert all(_bit_err(x, y) == 0.0
               for x, y in zip((z, s1, s2), again)), shape
    err = (z.float() - z_ref.float()).abs().max().item()
    tol = z_ref.float().abs().max().item() * 2.0 ** -7
    assert err <= tol, ("_mm_stats_kernel", shape, err, tol)
    for got, want in ((s1, s1_ref), (s2, s2_ref)):
        serr = (got - want).abs().max().item()
        stol = 1e-4 * want.abs().max().item()
        assert serr <= stol, ("_mm_stats_kernel sums", shape, serr, stol)
    return err, tol


def phase_conv_kernels(gen, smi):
    """#3 and #4 against their plain versions at the 9 shapes of the 26
    fused convs of a bs-64 ResNet-50 forward, each timed by
    :func:`conv_times` beside ``torch.matmul`` of the bare product; s1/s2
    (and z) must be bit-identical across calls.  Totals are summed over
    the 26 convs."""
    from horovod_tpu_torch.ops import conv_fused as cf

    summed = ("kernel_ms", "library_ms", "enqueue_ms", "back_to_back_ms",
              "plain_ms", "bound_ms")
    totals = {name: dict({key: 0.0 for key in summed}, max_abs_err=0.0,
                         bound_by={}, ptxas=kernel_ptxas(name))
              for name in ("_mm_kernel", "_mm_stats_kernel")}
    dev = torch.device("cuda")
    shapes = fused_conv_shapes(BATCH, IMAGE)
    for (m, k, n), count in sorted(shapes.items()):
        a, w = conv_operands(gen, m, k, n)
        scale = 1.0 + 0.1 * torch.randn(n, generator=gen, device=dev)
        bias = 0.1 * torch.randn(n, generator=gen, device=dev)
        flops = 2.0 * m * n * k
        io = 2.0 * (m * k + k * n + m * n)
        shape = {"shape": [m, k, n], "per_forward": count}

        # #3: relu((a @ w) * scale + bias)
        y = cf._mm_forward(a, w, scale, bias, True)
        y_ref = cf._mm_forward_plain(a, w, scale, bias, True)
        torch.cuda.synchronize()
        err = (y.float() - y_ref.float()).abs().max().item()
        # One bf16 ulp at the largest output: both round an f32 sum that
        # differs only in summation order.
        tol = y_ref.float().abs().max().item() * 2.0 ** -7
        assert err <= tol, ("_mm_kernel", (m, k, n), err, tol)
        b_ms, b_by = bound(io + 8.0 * n, flops, PEAK_BF16_FLOPS)
        row = dict(conv_times(lambda: cf._mm_forward(a, w, scale, bias, True),
                              lambda: cf._mm_forward_plain(a, w, scale, bias,
                                                           True),
                              lambda: torch.matmul(a, w)), bound_ms=b_ms)
        emit({"phase": "kernel", "name": "_mm_kernel", **shape,
              "max_abs_err": err, "tolerance": tol, "bound_by": b_by,
              "fraction_of_bound": b_ms / row["kernel_ms"], **row})
        tot = totals["_mm_kernel"]
        for key in summed:
            tot[key] += count * row[key]
        tot["max_abs_err"] = max(tot["max_abs_err"], err)
        tot["bound_by"][b_by] = tot["bound_by"].get(b_by, 0) + count
        del y, y_ref

        # #4: z = a @ w, per-BLOCK_M-row partial sums of z and z^2
        err, tol = check_mm_stats(cf, a, w)
        nb = -(-m // cf.BLOCK_M)
        b_ms, b_by = bound(io + 8.0 * nb * n, flops, PEAK_BF16_FLOPS)
        row = dict(conv_times(lambda: cf.matmul_batch_stats(a, w),
                              lambda: cf._mm_stats_plain(a, w),
                              lambda: torch.matmul(a, w)), bound_ms=b_ms)
        emit({"phase": "kernel", "name": "_mm_stats_kernel", **shape,
              "max_abs_err": err, "tolerance": tol, "bound_by": b_by,
              "fraction_of_bound": b_ms / row["kernel_ms"], **row})
        tot = totals["_mm_stats_kernel"]
        for key in summed:
            tot[key] += count * row[key]
        tot["max_abs_err"] = max(tot["max_abs_err"], err)
        tot["bound_by"][b_by] = tot["bound_by"].get(b_by, 0) + count
        del a, w
        torch.cuda.empty_cache()
    for name, tot in totals.items():
        emit({"phase": "kernel_total", "name": name,
              "convs": sum(shapes.values()),
              "fraction_of_bound": tot["bound_ms"] / tot["kernel_ms"],
              "over_library": tot["kernel_ms"] / tot["library_ms"],
              "card": smi, **tot})
    return totals


def optim_row(name, base, gen, make_opt, make_lib, bytes_per, flops_per,
              plain_iters=10):
    """#1 or #2 as a train step calls it: ``make_opt(leaves,
    use_kernels).step()`` over clones of ``base`` with random grads set,
    through the kernel and through the plain version from the same state
    (two steps, every parameter and moment held bit-identical), then
    timed: the kernel step by CUDA events back to back, by CUDA events
    behind a device sleep (the device alone) and by the host clock of
    its enqueue (median, min, max), the plain step, and ``make_lib`` (a
    torch.optim optimizer of the same function) on the same leaves."""
    from horovod_tpu_torch.ops import optim_kernels as ok

    grads = [torch.empty_like(b).normal_(generator=gen).mul_(0.01)
             for b in base]
    sides = []
    for use_kernels in (True, False):
        leaves = [b.detach().clone() for b in base]
        for q, g in zip(leaves, grads):
            q.grad = g
        opt = make_opt(leaves, use_kernels)
        before = ok._sgd_multi.launches + ok._adam_multi.launches
        for _ in range(2):
            opt.step()
        launches = ok._sgd_multi.launches + ok._adam_multi.launches - before
        assert launches == (2 if use_kernels else 0), (name, launches)
        sides.append((leaves, opt))
    torch.cuda.synchronize()
    (kl, kopt), (pl, popt) = sides
    err = 0.0
    for a, b in zip(kl, pl):
        err = max(err, _bit_err(a, b), *(
            _bit_err(kopt.state[a][k], popt.state[b][k])
            for k in kopt.state[a]))
    assert err == 0.0, (name, err)
    lib = [b.detach().clone() for b in base]
    for t, g in zip(lib, grads):
        t.grad = g
    try:
        library_ms = cuda_ms(make_lib(lib).step)
    except (RuntimeError, TypeError) as e:   # no fused form in this torch
        print(f"library optimizer unavailable: {e}", file=sys.stderr)
        library_ms = None
    n_params = sum(b.numel() for b in base)
    kern = cuda_ms_stats(kopt.step)
    dev = device_ms_stats(kopt.step)
    host = enqueue_ms_stats(kopt.step)
    b_ms, b_by = bound(float(bytes_per) * n_params,
                       float(flops_per) * n_params, PEAK_F32_FLOPS)
    row = {"kernel_ms": kern["median"], "kernel_ms_min": kern["min"],
           "kernel_ms_max": kern["max"], "device_ms": dev["median"],
           "device_ms_min": dev["min"], "device_ms_max": dev["max"],
           "host_ms": host["median"],
           "host_ms_min": host["min"], "host_ms_max": host["max"],
           "plain_ms": cuda_ms(popt.step, iters=plain_iters),
           "library_ms": library_ms, "bound_ms": b_ms, "bound_by": b_by,
           "max_abs_err": err}
    del sides, kl, pl, kopt, popt, lib, grads
    torch.cuda.empty_cache()
    return row, n_params


def phase_optim_kernels(params, gen):
    """#2 and #1 over all ResNet-50 leaves: one FusedSGD(0.01, momentum
    0.9) / FusedAdam(1e-3) step, as the train and adam phases call it."""
    from horovod_tpu_torch.ops import optim_kernels as ok

    results = {}
    for name, make_opt, make_lib, bytes_per, flops_per in (
            ("_sgd_kernel",
             lambda ls, uk: ok.fused_sgd(ls, 0.01, momentum=0.9,
                                         use_kernels=uk),
             lambda ls: torch.optim.SGD(ls, lr=0.01, momentum=0.9,
                                        fused=True), 20, 4),
            ("_adam_kernel",
             lambda ls, uk: ok.fused_adam(ls, 1e-3, use_kernels=uk),
             lambda ls: torch.optim.Adam(ls, lr=1e-3, fused=True), 28, 12)):
        row, n_params = optim_row(name, params, gen, make_opt, make_lib,
                                  bytes_per, flops_per)
        emit({"phase": "kernel", "name": name, "leaves": len(params),
              "params": n_params, "tolerance": 0.0, **row})
        results[name] = row
    return results


def phase_optim_lm(gen, smi, shapes):
    """#1 over clones of the bert-large leaves (``shapes``): one
    FusedAdam(3e-4, weight_decay=1e-4) step as the LM phases call it,
    beside torch.optim.AdamW(fused=True), the same decoupled decay."""
    from horovod_tpu_torch.ops import optim_kernels as ok

    base = [torch.randn(s, generator=gen, device=gen.device)
            for s in shapes]
    row, n_params = optim_row(
        "_adam_kernel", base, gen,
        lambda ls, uk: ok.fused_adam(ls, 3e-4, weight_decay=1e-4,
                                     use_kernels=uk),
        lambda ls: torch.optim.AdamW(ls, lr=3e-4, weight_decay=1e-4,
                                     fused=True), 28, 12, plain_iters=3)
    emit({"phase": "optim_lm", "name": "_adam_kernel", "leaves": len(base),
          "params": n_params, "tolerance": 0.0, "card": smi, **row})
    del base
    torch.cuda.empty_cache()
    return row


QUANT_BLOCK = 256


def _bits(t):
    """A tensor's bytes as integers of its element size, for bit-identity
    checks."""
    return t.contiguous().view({1: torch.uint8, 2: torch.int16,
                                4: torch.int32,
                                8: torch.int64}[t.element_size()])


def _bit_err(got, want) -> float:
    """0 when ``got`` and ``want`` hold the same bytes, else the largest
    absolute difference of their values."""
    assert got.shape == want.shape and got.dtype == want.dtype
    if torch.equal(_bits(got), _bits(want)):
        return 0.0
    return (got.double() - want.double()).abs().max().item() or math.inf


def phase_quant_kernels(params, gen):
    """#5-#8 against their plain versions at each fused-bucket size of
    the ResNet-50 gradients.  Tolerance 0: the max is exact and every
    other step is one IEEE f32 operation on both sides.  Each is timed on
    the device alone (``kernel_ms``: CUDA events behind a device sleep),
    by the host's enqueue of one call and back to back (which the host
    bounds at these sizes); the totals sum the bucket sizes."""
    from horovod_tpu_torch.ops import device as tdev
    from horovod_tpu_torch.quant import kernels as qk

    sizes = [sum(params[i].numel() for i in b)
             for b in tdev.fused_allreduce_buckets(params, None)]
    summed = ("kernel_ms", "enqueue_ms", "back_to_back_ms", "plain_ms",
              "bound_ms")
    totals = {name: dict({key: 0.0 for key in summed}, max_abs_err=0.0)
              for name in ("_quant_kernel", "_dequant_kernel",
                           "_quant4_kernel", "_dequant4_kernel")}
    for size in sizes:
        padded = -(-size // QUANT_BLOCK) * QUANT_BLOCK
        nb = padded // QUANT_BLOCK
        x = torch.randn(padded, generator=gen, device="cuda").mul_(1e-2)
        x[:QUANT_BLOCK] = 0.0                   # an all-zero block
        x2 = x.view(nb, QUANT_BLOCK)
        q, s = qk._quantize_cuda(x2)
        q4, s4 = qk._quantize4_cuda(x2)
        # (name, kernel call, plain call, outputs, bytes, ops)
        cases = (
            ("_quant_kernel", lambda: qk._quantize_cuda(x2),
             lambda: qk._quantize_plain(x2), 5.0 * padded + 4.0 * nb,
             5.0 * padded),
            ("_dequant_kernel", lambda: qk._dequantize_cuda(q, s),
             lambda: qk._dequantize_plain(q, s), 5.0 * padded + 4.0 * nb,
             1.0 * padded),
            ("_quant4_kernel", lambda: qk._quantize4_cuda(x2),
             lambda: qk._quantize4_plain(x2), 4.5 * padded + 4.0 * nb,
             5.0 * padded),
            ("_dequant4_kernel", lambda: qk._dequantize4_cuda(q4, s4),
             lambda: qk._dequantize4_plain(q4, s4),
             4.5 * padded + 4.0 * nb, 1.0 * padded))
        for name, kern, plain, nbytes, ops in cases:
            got, want = kern(), plain()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            torch.cuda.synchronize()
            err = max(_bit_err(g, w) for g, w in zip(got, want))
            assert err == 0.0, (name, size, err)
            b_ms, b_by = bound(nbytes, ops, PEAK_F32_FLOPS)
            dev = device_ms_stats(kern, iters=20)
            row = {"kernel_ms": dev["median"],
                   "enqueue_ms": enqueue_ms_stats(kern)["median"],
                   "back_to_back_ms": cuda_ms(kern),
                   "plain_ms": cuda_ms(plain), "bound_ms": b_ms}
            emit({"phase": "quant_kernel", "name": name, "elements": padded,
                  "block": QUANT_BLOCK, "max_abs_err": err, "tolerance": 0.0,
                  "bound_by": b_by, "library_ms": None,
                  "kernel_ms_min": dev["min"], "kernel_ms_max": dev["max"],
                  "fraction_of_bound": b_ms / dev["median"], **row})
            tot = totals[name]
            for key in summed:
                tot[key] += row[key]
            tot["bound_by"] = b_by
        del x, q, s, q4, s4
    for name, tot in totals.items():
        emit({"phase": "quant_kernel_total", "name": name,
              "buckets": len(sizes),
              "fraction_of_bound": tot["bound_ms"] / tot["kernel_ms"], **tot})
    return totals, sizes


# The LM path's attention shape: bert-large at seq 4096, batch 16.
LM_BATCH, LM_SEQ, LM_HEADS, LM_HEAD_DIM = 16, 4096, 16, 64


def _visible_pairs(lq: int, lk: int, q_offset: int, k_offset: int) -> int:
    """(q, k) pairs a causal pass needs: q_offset + i >= k_offset + j."""
    return sum(max(0, min(lk, q_offset + i - k_offset + 1))
               for i in range(lq))


def _flash_bounds(b, lq, lk, h, hkv, d, pairs, carry=False):
    """(bound_ms, bound_by) of #9 (finished form), #10 and #11: each
    input read once, each output written once (o in bf16; dq and the
    per-q-head dk/dv in f32; lse and delta one f32 per row); 2 FLOP per
    multiply-add over the visible pairs, two products in the forward,
    three in dQ, four in dK/dV.  With ``carry``, #9 is a ring step
    (flash_block_update): it reads and writes the f32 carry (acc, m, l)
    in place of writing o and lse."""
    q_bytes, kv_bytes = 2.0 * b * lq * h * d, 2.0 * b * lk * hkv * d
    row = 4.0 * b * h * lq
    per_product = 2.0 * b * h * d * pairs
    fwd_out = (2 * (2 * q_bytes + 2 * row) if carry else q_bytes + row)
    return {
        "_kernel": bound(q_bytes + 2 * kv_bytes + fwd_out,
                         2 * per_product, PEAK_BF16_FLOPS),
        "_dq_kernel": bound(4 * q_bytes + 2 * kv_bytes + 2 * row,
                            3 * per_product, PEAK_BF16_FLOPS),
        "_dkv_kernel": bound(2 * q_bytes + 2 * kv_bytes + 2 * row
                             + 2 * 4.0 * b * lk * h * d,
                             4 * per_product, PEAK_BF16_FLOPS),
    }


# One bf16 (fp16) ulp relative, 2^-7 (2^-10): the kernels and their plain
# versions round the same f32 quantities to 16 bits (P, dS, the outputs)
# and differ only in the order of their f32 sums, so a rounding lands one
# ulp apart now and then.  The logsumexp has no 16-bit rounding: 1e-5.
BF16_ULP, FP16_ULP, LSE_REL = 2.0 ** -7, 2.0 ** -10, 1e-5


def closeness(got, want, rel: float) -> dict:
    """How far ``got`` is from ``want``, each row against its own size.

    A row is one [D] vector (one batch, position and head) of an output
    shaped [B, L, H, D], else one value (lse, the carry's m and l).  The
    tolerance of a row is ``rel * (|want row| + rms row norm)``: its own
    L2 norm, plus the root-mean-square row norm as a floor for rows that
    are near zero (row 0 of dQ is a sum that cancels to rounding noise).
    Rows and not single elements, because an element of dQ or dK can
    cancel to near zero while its terms are large.  ``err_over_tol`` is
    the worst row's error over its tolerance: at most 1 to pass."""
    g, w = got.float(), want.float()
    diff = g - w
    if w.dim() == 4:
        err, size = diff.norm(dim=-1), w.norm(dim=-1)
    else:
        err, size = diff.abs(), w.abs()
    floor = size.square().mean().sqrt()
    worst = (err / (rel * (size + floor)).clamp_min(1e-30)).max().item()
    return {"max_abs_err": diff.abs().max().item(),
            "rel_l2": (diff.norm() / w.norm().clamp_min(1e-30)).item(),
            "rms_want": w.square().mean().sqrt().item(),
            "rel_tol": rel, "err_over_tol": worst}


def _flash_case(pk, b, lq, lk, h, hkv, gen, *, q_offset=0, k_offset=0,
                carry=False):
    """Random bf16 operands of one flash call, [B, L, H, D]."""
    d = LM_HEAD_DIM

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=gen.device).to(
            torch.bfloat16)

    case = dict(q=rnd(b, lq, h, d), k=rnd(b, lk, hkv, d),
                v=rnd(b, lk, hkv, d), do=rnd(b, lq, h, d),
                q_offset=q_offset, k_offset=k_offset, scale=d ** -0.5,
                block_q=pk._fit_block(lq, 512), block_k=pk._fit_block(lk, 512),
                block_kf=pk._fit_block(lk, 1024))
    if carry:
        case["carry"] = (
            torch.randn((b, lq, h, d), generator=gen, device=gen.device),
            torch.randn((b, h, lq), generator=gen, device=gen.device),
            1.0 + torch.rand((b, h, lq), generator=gen, device=gen.device))
    return case


def _flash_calls(pk, c):
    """{name: (kernel call, plain call)} of #9-#11 on case ``c``; the
    backward pair reads the kernel forward's (out, lse)."""
    fwd = dict(causal=True, scale=c["scale"], block_q=c["block_q"],
               block_k=c["block_kf"], finish=True)
    bwd = dict(causal=True, scale=c["scale"], block_q=c["block_q"],
               block_k=c["block_k"])
    args = (c["q"], c["k"], c["v"])
    offs = (c["q_offset"], c["k_offset"])
    out, lse = pk._flash_fwd(*args, None, *offs, **fwd)
    delta = (c["do"].float() * out.float()).sum(-1).transpose(1, 2)
    grad = (*args, c["do"], lse, delta, *offs)
    return {
        "_kernel": (lambda: pk._flash_fwd(*args, None, *offs, **fwd),
                    lambda: pk._flash_fwd_plain(*args, None, *offs, **fwd)),
        "_dq_kernel": (lambda: pk._flash_dq(*grad, **bwd),
                       lambda: pk._flash_dq_plain(*grad, **bwd)),
        "_dkv_kernel": (lambda: pk._flash_dkv(*grad, **bwd),
                        lambda: pk._flash_dkv_plain(*grad, **bwd)),
    }


def _compare(name, got, want, ulp=BF16_ULP):
    """:func:`closeness` of each of a kernel's outputs (a forward's
    logsumexp at ``LSE_REL``, the rest at ``ulp``); raises if any is out
    of tolerance."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    lse_at = 1 if name in ("_kernel", "_smallseq_fwd_kernel") else None
    outs = [closeness(g, w, LSE_REL if i == lse_at else ulp)
            for i, (g, w) in enumerate(zip(got, want))]
    assert all(o["err_over_tol"] <= 1.0 for o in outs), (name, outs)
    return outs


def _ragged_grads(pk, r):
    """:func:`closeness` of flash_grad_block's (dq, dk, dv) on case ``r``
    against the plain versions of #10 and #11 (one block of the whole
    length) and the same GQA group sum; the kernel forward gives (out,
    lse)."""
    q, k, v, do = r["q"], r["k"], r["v"], r["do"]
    offs = dict(q_offset=r["q_offset"], k_offset=r["k_offset"])
    b, lq, h, d = q.shape
    lk, hkv = k.shape[1], k.shape[2]
    out, lse = pk._flash_fwd(q, k, v, None, *offs.values(), causal=True,
                             scale=r["scale"], block_q=lq, block_k=lk,
                             finish=True)
    got = pk.flash_grad_block(q, k, v, do, out, lse, causal=True,
                              scale=r["scale"], **offs)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2)
    args = (q, k, v, do, lse, delta, *offs.values())
    kw = dict(causal=True, scale=r["scale"], block_q=lq, block_k=lk)
    dq = pk._flash_dq_plain(*args, **kw)
    dk, dv = (x.reshape(b, lk, hkv, h // hkv, d).sum(3)
              for x in pk._flash_dkv_plain(*args, **kw))
    return [closeness(g, w, BF16_ULP) for g, w in zip(got, (dq, dk, dv))]


def phase_flash_kernels(gen, smi):
    """#9-#11 against their plain versions at the LM path's shape, timed
    beside their bounds and scaled_dot_product_attention (forward, and its
    autograd backward, which computes dQ, dK and dV together); then a GQA
    case and an offset case of flash_block_update."""
    from horovod_tpu_torch.ops import pallas_kernels as pk

    b, l, h, d = LM_BATCH, LM_SEQ, LM_HEADS, LM_HEAD_DIM
    c = _flash_case(pk, b, l, l, h, h, gen)
    calls = _flash_calls(pk, c)
    bounds = _flash_bounds(b, l, l, h, h, d, _visible_pairs(l, l, 0, 0))
    qt, kt, vt, dot = (x.transpose(1, 2) for x in
                       (c["q"], c["k"], c["v"], c["do"]))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_fwd = cuda_ms(lambda: sdpa(qt, kt, vt, is_causal=True), iters=5)
    qg, kg, vg = (x.detach().requires_grad_() for x in (qt, kt, vt))
    og = sdpa(qg, kg, vg, is_causal=True)
    lib_bwd = cuda_ms(lambda: torch.autograd.grad(og, (qg, kg, vg), dot,
                                                  retain_graph=True), iters=5)
    library = {"_kernel": lib_fwd, "_dq_kernel": lib_bwd,
               "_dkv_kernel": lib_bwd}
    rows = {}
    for name, (kern, plain) in calls.items():
        outs = _compare(name, kern(), plain())
        b_ms, b_by = bounds[name]
        rows[name] = {"kernel_ms": cuda_ms(kern, iters=5),
                      "plain_ms": cuda_ms(plain, iters=1, reps=3, warmup=1),
                      "library_ms": library[name], "bound_ms": b_ms,
                      "bound_by": b_by,
                      "max_abs_err": max(o["max_abs_err"] for o in outs)}
        extra = {}
        if name == "_dkv_kernel":  # #10 + #11 against SDPA's whole backward
            pair = rows["_dq_kernel"]["kernel_ms"] + rows[name]["kernel_ms"]
            extra = {"pair_ms": pair, "pair_over_library": pair / lib_bwd}
        ptxas = kernel_ptxas(name)
        assert all("registers" in x for x in ptxas), (name, ptxas)
        emit({"phase": "flash_kernel", "name": name,
              "shape": [b, l, h, h, d], "dtype": "bf16", "causal": True,
              "outputs": outs, "card": smi, **rows[name], **extra,
              "fraction_of_bound": b_ms / rows[name]["kernel_ms"],
              "ptxas": ptxas})
    del c, calls, qt, kt, vt, dot, qg, kg, vg, og

    # GQA (Hkv 4), and flash_block_update's offset form with a carry.
    g = _flash_case(pk, 4, l, l, h, 4, gen)
    gqa = {name: _compare(name, kern(), plain())
           for name, (kern, plain) in _flash_calls(pk, g).items()}
    o = _flash_case(pk, 4, 2048, 2048, h, h, gen, q_offset=2048,
                    k_offset=1024, carry=True)
    upd = dict(q_offset=o["q_offset"], k_offset=o["k_offset"], causal=True,
               scale=o["scale"])
    got = pk.flash_block_update(o["q"], o["k"], o["v"], *o["carry"], **upd)
    want = pk._flash_fwd_plain(o["q"], o["k"], o["v"], o["carry"],
                               o["q_offset"], o["k_offset"], causal=True,
                               scale=o["scale"], block_q=512, block_k=1024,
                               finish=False)
    # The carry's acc sums P V unnormalized, P rounded to bf16 as in the
    # forward: one bf16 ulp per row, as there; m and l are f32.
    upd = [closeness(gt, w, BF16_ULP) for gt, w in zip(got, want)]
    # Ragged: L 1000 (off the kernel's 128-row q and K/V tiles), Hkv 4,
    # k_offset 16 past q_offset so q rows 0-15 see no key and pass their
    # carry through bit for bit.
    r = _flash_case(pk, 4, 1000, 1000, h, 4, gen, q_offset=8, k_offset=24,
                    carry=True)
    rag = dict(q_offset=r["q_offset"], k_offset=r["k_offset"], causal=True,
               scale=r["scale"])
    got_r = pk.flash_block_update(r["q"], r["k"], r["v"], *r["carry"], **rag)
    want_r = pk._flash_fwd_plain(r["q"], r["k"], r["v"], r["carry"],
                                 r["q_offset"], r["k_offset"], causal=True,
                                 scale=r["scale"], block_q=1000,
                                 block_k=1000, finish=False)
    ragged = [closeness(gt, w, BF16_ULP) for gt, w in zip(got_r, want_r)]
    unseen = all(torch.equal(gt[:, :16] if gt.dim() == 4 else gt[:, :, :16],
                             c[:, :16] if c.dim() == 4 else c[:, :, :16])
                 for gt, c in zip(got_r, r["carry"]))
    # The backward of the same ragged case through flash_grad_block (#10,
    # #11 and the GQA group sum): rows 0-15 see no key (lse about -1e30).
    grads = _ragged_grads(pk, r)
    emit({"phase": "flash_kernel", "gqa": {"shape": [4, l, h, 4, d],
                                           "outputs": gqa},
          "block_update": {"shape": [4, 2048, h, h, d], "q_offset": 2048,
                           "k_offset": 1024, "outputs": upd},
          "ragged": {"shape": [4, 1000, h, 4, d], "q_offset": 8,
                     "k_offset": 24, "outputs": ragged,
                     "unseen_rows_pass_through": unseen,
                     "grad_block": grads}})
    assert all(o["err_over_tol"] <= 1.0 for o in upd), upd
    assert all(o["err_over_tol"] <= 1.0 for o in ragged), ragged
    assert all(o["err_over_tol"] <= 1.0 for o in grads), grads
    assert unseen, "rows that see no key changed their carry"
    del g, o, got, want, r, got_r, want_r
    return rows


# The ring phase: a ring of 4 members at ring-local shard length 4096 and
# batch 4 (global L 16384; tools/ring_ab.py's middle shard), at the LM
# path's attention width.
RING_SP, RING_SHARD, RING_BATCH = 4, 4096, 4


def _attn_grads(fn, q, k, v, do):
    """(out, dq, dk, dv) of ``fn(q, k, v)`` under the cotangent ``do``."""
    q, k, v = (x.detach().clone().requires_grad_() for x in (q, k, v))
    out = fn(q, k, v)
    return (out.detach(), *torch.autograd.grad(out, (q, k, v), do))


def _flash_kernel_bwd(pk, q, k, v, do, causal):
    """flash_attention's forward (#9) and, under HVDT_FLASH_BWD=kernel,
    its kernel backward (#10, #11): (out, dq, dk, dv)."""
    before = os.environ.get("HVDT_FLASH_BWD")
    os.environ["HVDT_FLASH_BWD"] = "kernel"
    try:
        return _attn_grads(lambda *a: pk.flash_attention(*a, causal=causal),
                           q, k, v, do)
    finally:
        if before is None:
            del os.environ["HVDT_FLASH_BWD"]
        else:
            os.environ["HVDT_FLASH_BWD"] = before


def _ring_launches(want):
    """The counters of #9-#11 since the last reset, held to ``want``
    (and every other kernel to 0)."""
    torch.cuda.synchronize()
    got = counters()
    assert all(got[n] == want.get(n, 0) for n in got), (got, want)
    return {n: got[n] for n in ("_kernel", "_dq_kernel", "_dkv_kernel")}


def ring_entry(pk, ring_attention, gen, smi):
    """ring_attention in the NCCL world of one at the lm_train shape (one
    diagonal step, no transfer), forward and backward, against
    flash_attention with the kernel backward; then the plain step at B 1
    against the kernel step."""
    import torch.distributed as dist

    b, l, h = LM_BATCH, LM_SEQ, LM_HEADS
    c = _flash_case(pk, b, l, l, h, h, gen)
    args = (c["q"], c["k"], c["v"], c["do"])
    world = dist.group.WORLD

    def ring(use_pallas):
        return lambda q, k, v: ring_attention(q, k, v, group=world,
                                              use_pallas=use_pallas)

    reset_counters()
    got = _attn_grads(ring(True), *args)
    launches = _ring_launches({"_kernel": 1, "_dq_kernel": 1,
                               "_dkv_kernel": 1})
    want = _flash_kernel_bwd(pk, *args, causal=True)
    names = ("out", "dq", "dk", "dv")
    vs_flash = {n: closeness(g, w, BF16_ULP)
                for n, g, w in zip(names, got, want)}
    del got, want
    # The plain step at B 1: 4096^2 f32 scores a head, 1 GiB.
    one = tuple(x[:1] for x in args)
    reset_counters()
    plain = _attn_grads(ring(False), *one)
    plain_launches = _ring_launches({})
    kern = _attn_grads(ring(True), *one)
    # The kernel step rounds P and dS to bf16 before its products, the
    # plain step keeps them in f32: on the CPU, against the kernels' plain
    # versions (B 1, H 2, L 1024-2048), 0.44-0.49 of one bf16 ulp a row;
    # the kernels stay within one ulp of their plain versions.  2^-6.
    plain_rel = 2 * BF16_ULP
    vs_kernel = {n: closeness(g, w, plain_rel)
                 for n, g, w in zip(names, plain, kern)}
    emit({"phase": "ring_entry", "shape": [b, l, h, h, LM_HEAD_DIM],
          "dtype": "bf16", "causal": True, "members": 1,
          "launches": launches, "vs_flash_attention": vs_flash,
          "plain_shape": [1, l, h, h, LM_HEAD_DIM],
          "plain_launches": plain_launches,
          "plain_vs_kernel_step": vs_kernel, "card": smi})
    assert all(o["err_over_tol"] <= 1.0 for o in vs_flash.values()), vs_flash
    assert all(o["err_over_tol"] <= 1.0 for o in vs_kernel.values()), \
        vs_kernel


def _virtual_ring(rmod, shards, causal, scale, use_pallas):
    """Every member of a ring in turn, through the ring module's step
    functions, the rotation done by indexing the shard lists (q, k, v,
    do): the assembled (out, dq, dk, dv) in bf16."""
    qs, ks, vs, dos = shards
    sp = len(qs)
    kw = dict(causal=causal, scale=scale, use_pallas=use_pallas)
    outs, lses = [], []
    for my in range(sp):
        carry = rmod._init_carry(qs[my])
        for s in range(sp):
            src = (my - s) % sp
            carry = rmod._forward_step(qs[my], ks[src], vs[src], carry,
                                       src=src, my=my, **kw)
        out, lse = rmod._finish(carry, qs[my].dtype)
        outs.append(out)
        lses.append(lse)
    dq = [torch.zeros(x.shape, dtype=torch.float32, device=x.device)
          for x in qs]
    dk = [torch.zeros(x.shape, dtype=torch.float32, device=x.device)
          for x in ks]
    dv = [torch.zeros_like(x) for x in dk]
    for my in range(sp):
        inp = rmod._bwd_inputs(qs[my], dos[my], outs[my], lses[my],
                               use_pallas)
        for s in range(sp):
            src = (my - s) % sp
            g = rmod._backward_step(inp, ks[src], vs[src], src=src, my=my,
                                    **kw)
            if g is not None:
                dq[my] += g[0]
                dk[src] += g[1]
                dv[src] += g[2]
        del inp
    return [torch.cat(x, 1).to(torch.bfloat16) for x in (outs, dq, dk, dv)]


def ring_virtual(pk, rmod, gen, smi, causal):
    """Every member of a ring of RING_SP in turn, through the ring
    module's step functions; the assembled output and gradients against
    whole-sequence flash_attention (#9, and #10/#11 under
    HVDT_FLASH_BWD=kernel); then the same ring at B 1 with the plain step
    (fully visible and diagonal steps, 1 GiB of f32 scores each) against
    the kernel ring."""
    sp, n, h, d = RING_SP, RING_SHARD, LM_HEADS, LM_HEAD_DIM
    c = _flash_case(pk, RING_BATCH, sp * n, sp * n, h, h, gen)
    scale = c["scale"]
    shards = [[c[x][:, i * n:(i + 1) * n].contiguous() for i in range(sp)]
              for x in ("q", "k", "v", "do")]
    steps = sp * (sp + 1) // 2 if causal else sp * sp
    names = ("out", "dq", "dk", "dv")
    reset_counters()
    got = _virtual_ring(rmod, shards, causal, scale, True)
    launches = _ring_launches({"_kernel": steps, "_dq_kernel": steps,
                               "_dkv_kernel": steps})
    want = _flash_kernel_bwd(pk, c["q"], c["k"], c["v"], c["do"], causal)
    vs_whole = {name: closeness(g, w, BF16_ULP)
                for name, g, w in zip(names, got, want)}
    del got, want
    one = [[x[:1] for x in xs] for xs in shards]
    reset_counters()
    plain = _virtual_ring(rmod, one, causal, scale, False)
    plain_launches = _ring_launches({})
    kern = _virtual_ring(rmod, one, causal, scale, True)
    # 2^-6, as ring_entry holds the plain step to the kernel step.
    vs_kernel = {name: closeness(g, w, 2 * BF16_ULP)
                 for name, g, w in zip(names, plain, kern)}
    del plain, kern, one, shards
    emit({"phase": "ring_virtual", "members": sp, "shard": n,
          "global_seq": sp * n, "batch": RING_BATCH, "heads": h,
          "head_dim": d, "dtype": "bf16", "causal": causal,
          "steps_computed": steps, "launches": launches,
          "vs_whole_sequence": vs_whole, "plain_batch": 1,
          "plain_launches": plain_launches,
          "plain_vs_kernel_ring": vs_kernel, "card": smi})
    assert all(o["err_over_tol"] <= 1.0 for o in vs_whole.values()), vs_whole
    assert all(o["err_over_tol"] <= 1.0 for o in vs_kernel.values()), \
        vs_kernel


def ring_step(pk, gen, smi):
    """Device-alone times of one fully visible and one diagonal ring step
    at the ring-local shape (#9 through flash_block_update, #10 and #11
    as flash_grad_block calls them), each beside its bound; then the
    summed ring of RING_SP against the whole-sequence kernels."""
    sp, n, h, d = RING_SP, RING_SHARD, LM_HEADS, LM_HEAD_DIM
    b = RING_BATCH
    c = _flash_case(pk, b, n, n, h, h, gen, carry=True)
    q, k, v, do, scale = c["q"], c["k"], c["v"], c["do"], c["scale"]
    carry = tuple(x.contiguous() for x in c["carry"])
    out, lse = pk._flash_fwd(q, k, v, None, 0, 0, causal=True, scale=scale,
                             block_q=512, block_k=1024, finish=True)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    bw = dict(scale=scale, block_q=512, block_k=512)
    steps = {}
    for case, causal in (("full", False), ("diagonal", True)):
        pairs = n * n if not causal else _visible_pairs(n, n, 0, 0)
        bounds = _flash_bounds(b, n, n, h, h, d, pairs, carry=True)
        grad = (q, k, v, do, lse, delta, 0, 0)
        calls = {
            "_kernel": lambda: pk.flash_block_update(
                q, k, v, *carry, q_offset=0, k_offset=0, causal=causal,
                scale=scale),
            "_dq_kernel": lambda: pk._flash_dq(*grad, causal=causal, **bw),
            "_dkv_kernel": lambda: pk._flash_dkv(*grad, causal=causal, **bw),
        }
        row = {}
        for name, fn in calls.items():
            t = device_ms_stats(fn, iters=5)
            b_ms, b_by = bounds[name]
            row[name] = {"device_ms": t, "bound_ms": b_ms, "bound_by": b_by,
                         "fraction_of_bound": b_ms / t["median"]}
        row["flash_grad_block"] = {"device_ms": device_ms_stats(
            lambda: pk.flash_grad_block(q, k, v, do, out, lse, causal=causal,
                                        scale=scale, delta=delta), iters=5)}
        steps[case] = row
        emit({"phase": "ring_step", "case": case, "causal": causal,
              "shape": [b, n, h, h, d], "dtype": "bf16",
              "visible_pairs_per_head": pairs, **row,
              "note": "per-member device time of one ring step; the "
                      "transfers are not timed (one card has no peer)",
              "card": smi})
    del c, q, k, v, do, carry, out, lse, delta
    # The whole sequence through the same kernels, against the ring's 10
    # causal steps summed over its members (sp diagonal, the rest full).
    w = _flash_case(pk, b, sp * n, sp * n, h, h, gen)
    wout, wlse = pk._flash_fwd(w["q"], w["k"], w["v"], None, 0, 0,
                               causal=True, scale=scale, block_q=512,
                               block_k=1024, finish=True)
    wdelta = (w["do"].float() * wout.float()).sum(-1).transpose(1, 2)
    wgrad = (w["q"], w["k"], w["v"], w["do"], wlse, wdelta.contiguous(), 0, 0)
    whole = {
        "_kernel": device_ms_stats(lambda: pk._flash_fwd(
            w["q"], w["k"], w["v"], None, 0, 0, causal=True, scale=scale,
            block_q=512, block_k=1024, finish=True), iters=3)["median"],
        "_dq_kernel": device_ms_stats(lambda: pk._flash_dq(
            *wgrad, causal=True, **bw), iters=3)["median"],
        "_dkv_kernel": device_ms_stats(lambda: pk._flash_dkv(
            *wgrad, causal=True, **bw), iters=3)["median"],
    }
    n_full, n_diag = sp * (sp - 1) // 2, sp
    summed = {name: n_full * steps["full"][name]["device_ms"]["median"]
              + n_diag * steps["diagonal"][name]["device_ms"]["median"]
              for name in whole}
    last = {name: (sp - 1) * steps["full"][name]["device_ms"]["median"]
            + steps["diagonal"][name]["device_ms"]["median"]
            for name in whole}
    emit({"phase": "ring_step", "case": "ring_vs_whole", "members": sp,
          "global_shape": [b, sp * n, h, h, d], "causal": True,
          "ring_summed_ms": summed, "whole_sequence_ms": whole,
          "ring_over_whole": {k_: summed[k_] / whole[k_] for k_ in whole},
          "last_member_ms": last,
          "carry_bytes_per_step": 2 * 4 * b * n * h * d,
          "note": "device time of the ring's kernel steps; the transfers "
                  "are not timed (one card has no peer)", "card": smi})
    del w, wout, wlse, wdelta, wgrad


def phase_ring(gen, smi):
    """ring_entry, ring_virtual (causal and not) and ring_step."""
    import importlib

    from horovod_tpu_torch.ops import pallas_kernels as pk

    # The package exports the function under the module's name.
    rmod = importlib.import_module(
        "horovod_tpu_torch.parallel.ring_attention")
    ring_entry(pk, rmod.ring_attention, gen, smi)
    for causal in (True, False):
        ring_virtual(pk, rmod, gen, smi, causal)
    ring_step(pk, gen, smi)
    torch.cuda.empty_cache()


# The whole-sequence path: bert-large at seq 512, batch 128 (the
# tools/tpu_ab.py lm_smallseq_hb8_bs128 leg).
SS_BATCH, SS_SEQ = 128, 512


def _smallseq_case(gen, b, l, h, hkv, d, dtype):
    """Random operands of one smallseq call, [B, L, H, D]."""
    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=gen.device).to(dtype)

    return dict(q=rnd(b, l, h, d), k=rnd(b, l, hkv, d), v=rnd(b, l, hkv, d),
                do=rnd(b, l, h, d))


def _smallseq_calls(pk, c, causal):
    """{name: (kernel call, plain call)} of #12 and #13 on case ``c``; the
    backward pair reads the kernel forward's (out, lse)."""
    _, _, h, d = c["q"].shape
    kw = dict(causal=causal, scale=d ** -0.5,
              hb=pk._fit_heads_per_block(h, h // c["k"].shape[2], 8))
    args = (c["q"], c["k"], c["v"])
    out, lse = pk._smallseq_fwd(*args, **kw)
    grad = (*args, c["do"], out, lse)
    return {
        "_smallseq_fwd_kernel": (lambda: pk._smallseq_fwd(*args, **kw),
                                 lambda: pk._smallseq_fwd_plain(*args, **kw)),
        "_smallseq_bwd_kernel": (lambda: pk._smallseq_bwd(*grad, **kw),
                                 lambda: pk._smallseq_bwd_plain(*grad, **kw)),
    }


def _smallseq_bounds(b, l, h, hkv, d, causal):
    """(bound_ms, bound_by) of #12 and #13: each input read once, each
    output written once, all 16-bit but the f32 lse (one value a row);
    #12 reads q, k, v and writes o and lse, #13 reads q, k, v, dO, O and
    lse and writes dq, dk, dv.  2 FLOP per multiply-add over the (q, k)
    pairs the mask keeps: two products in the forward, five in the
    backward (q kᵀ, dO vᵀ, dV, dQ, dK)."""
    q_bytes, kv_bytes = 2.0 * b * l * h * d, 2.0 * b * l * hkv * d
    row = 4.0 * b * h * l
    pairs = l * (l + 1) // 2 if causal else l * l
    per_product = 2.0 * b * h * d * pairs
    return {
        "_smallseq_fwd_kernel": bound(2 * q_bytes + 2 * kv_bytes + row,
                                      2 * per_product, PEAK_BF16_FLOPS),
        "_smallseq_bwd_kernel": bound(4 * q_bytes + 4 * kv_bytes + row,
                                      5 * per_product, PEAK_BF16_FLOPS),
    }


def _smallseq_bwd_floor(b, l, h, hkv, d):
    """Bytes #13's two launches must move as designed, each input read once
    a launch: dQ reads q, dO, O, k and v and writes dq and delta; dK/dV
    reads k, v, q, dO, lse and delta and writes dk and dv."""
    q_bytes, kv_bytes = 2.0 * b * l * h * d, 2.0 * b * l * hkv * d
    row = 4.0 * b * h * l
    return (4 * q_bytes + 2 * kv_bytes + row) + (
        2 * q_bytes + 4 * kv_bytes + 2 * row)


def profiled_launches(fn, match, calls=5):
    """The CUDA kernels whose name contains ``match`` that one call of
    ``fn`` launches (torch.profiler over ``calls`` calls): their count a
    call and each one's mean device time in ms, or None where the
    profiler records no device activity."""
    import re

    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if match in e.key]
    if not events:
        return None
    names = [re.search(r"(\w+)<", e.key) for e in events]
    return {"launches": sum(e.count for e in events) / calls,
            "device_ms": {(n.group(1) if n else e.key): e.device_time_total
                          / e.count / 1e3 for n, e in zip(names, events)}}


def phase_smallseq_kernels(gen, smi):
    """#12 and #13 against their plain versions at the seq-512 LM path's
    shape, each timed on the device alone (CUDA events behind a device
    sleep) and back to back, beside its bound and
    scaled_dot_product_attention timed both ways (forward for #12, its
    autograd backward for #13); #13's line adds its design's byte floor
    and its launches a call with each one's device time; then smaller
    GQA, D 128, non-causal, fp16 and ragged cases."""
    from horovod_tpu_torch.ops import pallas_kernels as pk

    b, l, h, d = SS_BATCH, SS_SEQ, LM_HEADS, LM_HEAD_DIM
    c = _smallseq_case(gen, b, l, h, h, d, torch.bfloat16)
    calls = _smallseq_calls(pk, c, True)
    bounds = _smallseq_bounds(b, l, h, h, d, True)
    qt, kt, vt, dot = (x.transpose(1, 2) for x in
                       (c["q"], c["k"], c["v"], c["do"]))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qg, kg, vg = (x.detach().requires_grad_() for x in (qt, kt, vt))
    og = sdpa(qg, kg, vg, is_causal=True)
    library = {"_smallseq_fwd_kernel": lambda: sdpa(qt, kt, vt,
                                                    is_causal=True),
               "_smallseq_bwd_kernel": lambda: torch.autograd.grad(
                   og, (qg, kg, vg), dot, retain_graph=True)}
    rows = {}
    for name, (kern, plain) in calls.items():
        outs = _compare(name, kern(), plain())
        b_ms, b_by = bounds[name]
        dev = device_ms_stats(kern, iters=20)
        lib = device_ms_stats(library[name], iters=20)
        rows[name] = {"kernel_ms": dev["median"], "kernel_ms_min": dev["min"],
                      "kernel_ms_max": dev["max"],
                      "back_to_back_ms": cuda_ms(kern),
                      "plain_ms": cuda_ms(plain, iters=1, reps=3, warmup=1),
                      "library_ms": lib["median"],
                      "library_ms_min": lib["min"],
                      "library_ms_max": lib["max"],
                      "library_back_to_back_ms": cuda_ms(library[name]),
                      "bound_ms": b_ms, "bound_by": b_by,
                      "max_abs_err": max(o["max_abs_err"] for o in outs)}
        extra = {}
        if name == "_smallseq_bwd_kernel":
            floor = _smallseq_bwd_floor(b, l, h, h, d)
            extra = {"over_library": dev["median"] / lib["median"],
                     "design_floor_gb": floor / 1e9,
                     "design_floor_ms": floor / PEAK_BYTES * 1e3,
                     "per_call": profiled_launches(kern, "smallseq_")}
        emit({"phase": "smallseq_kernel", "name": name,
              "shape": [b, l, h, h, d], "dtype": "bf16", "causal": True,
              "outputs": outs, "card": smi, **rows[name], **extra,
              "fraction_of_bound": b_ms / rows[name]["kernel_ms"],
              "ptxas": kernel_ptxas(name)})
    del c, calls, qt, kt, vt, dot, qg, kg, vg, og

    # (B, L, H, Hkv, D, dtype, causal) of the smaller cases.
    cases = {"gqa": (16, 512, 16, 4, 64, torch.bfloat16, True),
             "d128": (16, 512, 8, 8, 128, torch.bfloat16, True),
             "noncausal": (16, 512, 16, 16, 64, torch.bfloat16, False),
             "fp16": (16, 512, 16, 16, 64, torch.float16, True),
             "ragged": (16, 200, 16, 4, 64, torch.bfloat16, True)}
    done = {}
    for label, (b2, l2, h2, hkv2, d2, dtype, causal) in cases.items():
        c2 = _smallseq_case(gen, b2, l2, h2, hkv2, d2, dtype)
        ulp = FP16_ULP if dtype == torch.float16 else BF16_ULP
        done[label] = {"shape": [b2, l2, h2, hkv2, d2], "causal": causal,
                       "dtype": str(dtype).split(".")[-1], "outputs": {
                           name: _compare(name, kern(), plain(), ulp)
                           for name, (kern, plain)
                           in _smallseq_calls(pk, c2, causal).items()}}
        del c2
    emit({"phase": "smallseq_kernel", "cases": done})
    return rows


def lm_config(seq: int = LM_SEQ):
    """The repo's bert-large preset (examples/jax_transformer_lm.py) at
    ``seq``: at 4096 the tools/tpu_ab.py lm_seq4096_fbwd_kernel
    configuration, at 512 (the preset's own length) lm_smallseq_hb8_bs128
    at batch 128."""
    from horovod_tpu_torch.models import TransformerConfig

    return TransformerConfig(vocab=30528, layers=24, d_model=1024,
                             heads=LM_HEADS, kv_heads=LM_HEADS, d_ff=4096,
                             max_seq=seq, dtype=torch.bfloat16,
                             remat=True, loss_chunk=8192)


def run_lm_steps(model, opt, tokens, cfg, steps, before_step=None,
                 after_step=None, **groups):
    """``steps`` optimizer steps, each timed on the host clock between
    synchronizes; ``before_step`` runs once, after the first backward and
    before its optimizer step, ``after_step`` after every step.
    ``groups``: the ``sp_group`` / ``ep_group`` / ``pp_group`` of the
    loss."""
    from horovod_tpu_torch.models import transformer_loss

    times, losses = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt.zero_grad()
        loss = transformer_loss(model, tokens, cfg, **groups)
        loss.backward()
        if before_step is not None:
            before_step()
            before_step = None
        opt.step()
        losses.append(loss.item())
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if after_step is not None:
            after_step()
    return times, losses


def lm_grads(model, tokens, cfg):
    """The loss's gradients from the model's current state (no step)."""
    from horovod_tpu_torch.models import transformer_loss

    model.zero_grad(set_to_none=True)
    transformer_loss(model, tokens, cfg).backward()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return grads


def lm_train_phase(hvd, gen, smi, phase, seq, batch, per_step):
    """Train the bert-large preset at (``seq``, ``batch``) from seed 0
    (init, broadcast_parameters, DistributedOptimizer(fused_adam(3e-4,
    weight_decay=1e-4))) for 3 steps under the knobs already set, emit the
    ``phase`` line and hold every step's launches to ``per_step`` (kernel
    name -> count).  Returns (model, opt, tokens, cfg, launches of the
    run)."""
    from horovod_tpu_torch.models import (transformer_flops_per_token,
                                          transformer_init)

    cfg = lm_config(seq)
    model = transformer_init(0, cfg, device=gen.device)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = hvd.DistributedOptimizer(
        hvd.fused_adam(model.parameters(), 3e-4, weight_decay=1e-4))
    tokens = torch.randint(0, cfg.vocab, (batch, seq), generator=gen,
                           device=gen.device)
    tokens_per_step = batch * seq
    flops_per_token = transformer_flops_per_token(cfg)
    steps = 3
    steps_launches = []

    def count_step():
        total = counters()
        done = {n: sum(s[n] for s in steps_launches) for n in total}
        steps_launches.append({n: total[n] - done[n] for n in total})

    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    times, losses = run_lm_steps(model, opt, tokens, cfg, steps,
                                 after_step=count_step)
    launches = counters()
    steady = sorted(times[1:])[len(times[1:]) // 2]
    emit({"phase": phase, "model": "bert-large", "layers": cfg.layers,
          "d_model": cfg.d_model, "heads": cfg.heads, "d_ff": cfg.d_ff,
          "vocab": cfg.vocab, "batch": batch, "seq": seq,
          "params": sum(p.numel() for p in model.parameters()),
          "steps": steps, "losses": losses, "step_s": times,
          "steady_step_s": steady, "tokens_per_s": tokens_per_step / steady,
          "model_tflops": 3 * flops_per_token * tokens_per_step / steady
          / 1e12,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "launches": launches, "card": smi})
    assert all(math.isfinite(x) for x in losses), losses
    for step in steps_launches:
        assert all(step[n] == want for n, want in per_step.items()), step
        assert step["_adam_kernel"] == 1, step
    return model, opt, tokens, cfg, launches


def lm_default_phase(model, opt, tokens, cfg, smi, phase, knob, errs_key):
    """The default path with ``knob`` unset: its first step's gradients
    held against the gradients of the path just trained, from the same
    state, then 2 steps for their time.  Returns the 2 steps' launches.

    The attention kernels round P and dS to bf16 before their products
    (as the TPU kernels do); the default paths keep the scores and their
    gradients in f32.  Each rounding moves a term by up to 2^-9 relative,
    and a gradient is a sum of such terms with heavy cancellation, carried
    back through 24 layers: about 1e-2 relative L2 per tensor on a
    24-layer CPU rehearsal (d 256, seq 256).  5e-2 per tensor."""
    grads = lm_grads(model, tokens, cfg)
    del os.environ[knob]
    errs = {}

    def compare():
        for n, p in model.named_parameters():
            want = p.grad.float()
            errs[n] = ((grads[n].float() - want).norm() / want.norm()).item()

    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    times, losses = run_lm_steps(model, opt, tokens, cfg, 2,
                                 before_step=compare)
    launches = counters()
    grad_tol = 5e-2
    emit({"phase": phase, "steps": 2, "losses": losses, "step_s": times,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "launches": launches, errs_key: errs, "tolerance": grad_tol,
          "card": smi})
    assert all(math.isfinite(x) for x in losses), losses
    assert max(errs.values()) <= grad_tol, errs
    return launches


def phase_lm(hvd, gen, smi):
    """lm_train (the streaming kernels, HVDT_FLASH_ATTENTION unset so the
    auto gate engages) and lm_bwd_default (the blockwise backward);
    returns the lm_train launches."""
    os.environ.pop("HVDT_FLASH_ATTENTION", None)
    os.environ["HVDT_FLASH_BWD"] = "kernel"
    model, opt, tokens, cfg, launches = lm_train_phase(
        hvd, gen, smi, "lm_train", LM_SEQ, LM_BATCH,
        {"_kernel": 48, "_dq_kernel": 24, "_dkv_kernel": 24})
    d_launches = lm_default_phase(model, opt, tokens, cfg, smi,
                                  "lm_bwd_default", "HVDT_FLASH_BWD",
                                  "grad_rel_l2_vs_kernel_bwd")
    assert d_launches["_kernel"] == 48 * 2, d_launches
    assert d_launches["_dq_kernel"] == d_launches["_dkv_kernel"] == 0
    del model, opt, tokens
    torch.cuda.empty_cache()
    return launches


def phase_lm_smallseq(hvd, gen, smi):
    """lm_smallseq (HVDT_FLASH_SMALLSEQ=on, the other attention knobs
    unset) and lm_smallseq_default (the materialized scores); returns the
    lm_smallseq launches and the shapes of the model's leaves."""
    for knob in ("HVDT_FLASH_ATTENTION", "HVDT_FLASH_SMALLSEQ_HB",
                 "HVDT_FLASH_BWD"):
        os.environ.pop(knob, None)
    os.environ["HVDT_FLASH_SMALLSEQ"] = "on"
    model, opt, tokens, cfg, launches = lm_train_phase(
        hvd, gen, smi, "lm_smallseq", SS_SEQ, SS_BATCH,
        {"_smallseq_fwd_kernel": 48, "_smallseq_bwd_kernel": 24,
         "_kernel": 0, "_dq_kernel": 0, "_dkv_kernel": 0})
    d_launches = lm_default_phase(model, opt, tokens, cfg, smi,
                                  "lm_smallseq_default",
                                  "HVDT_FLASH_SMALLSEQ",
                                  "grad_rel_l2_vs_smallseq")
    for name in ("_kernel", "_dq_kernel", "_dkv_kernel",
                 "_smallseq_fwd_kernel", "_smallseq_bwd_kernel"):
        assert d_launches[name] == 0, d_launches
    shapes = [tuple(p.shape) for p in model.parameters()]
    del model, opt, tokens
    torch.cuda.empty_cache()
    return launches, shapes


# ---- slice 14: the fp8 matmul and the overlapped exchange (one card) --------

FP8_MKN = (65536, 1024, 4096)    # bert-large's MLP projection, 128 x 512
PEAK_FP8_FLOPS = 1979e12
OVERLAP_THRESHOLD = 8 * 1024 * 1024


def _fp8_operands(gen, m, k, n):
    x = torch.randn((m, k), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    w = torch.randn((k, n), generator=gen, device="cuda") * 0.02
    return x, w


def phase_fp8(hvd, gen, smi):
    """fp8: the e4m3 operands (scale, clip, cast) on the card bit for bit
    against the plain version's on the CPU; fp8_matmul's forward
    (torch._scaled_mm) against the plain product on the card; its
    straight-through backward against the plain f32 formula; times of
    _scaled_mm, of the whole fp8_matmul and of the bf16 torch.matmul at
    the bert-large projection shape; then the bert-large LM at seq 512,
    batch 128 (HVDT_FLASH_SMALLSEQ=on) with HVDT_FP8=matmul and off in
    turns.

    Tolerance of the product: the plain product sums the exact e4m3
    products in f32; Hopper's e4m3 tensor-core GEMM keeps its partial
    sums in less than f32 between promotions to f32 (torch._scaled_mm's
    default use_fast_accum=False promotes them, but not after every
    product).  So each element is held to one bf16 ulp of itself (2^-7
    of its magnitude) plus 2^-10 of the sum of its products' magnitudes
    (|qx| @ |qw| times the scales), about 8 units in the last place of
    a 13-bit-mantissa accumulator; the line reports the largest error
    over that sum.  The backward (bf16 or f32 operands into cuBLAS's
    f32 accumulation) is held to 2^-7 of each element plus 1e-5 of the
    largest."""
    from horovod_tpu_torch.quant import fp8

    t0 = time.perf_counter()
    assert fp8.fp8_available(), "no e4m3 GEMM on this card"
    m, k, n = FP8_MKN
    x, w = _fp8_operands(gen, m, k, n)
    sx = fp8._scale_for(x.abs().amax())
    sw = fp8._scale_for(w.abs().amax())
    bits = {}
    for name, t, s in (("x", x, sx), ("w", w, sw)):
        got = fp8._cast_e4m3(t, s).view(torch.uint8).cpu()
        want = fp8._cast_e4m3(t.cpu(), s.cpu()).view(torch.uint8)
        bits[name] = int((got != want).sum())
        assert bits[name] == 0, (name, bits[name])
    out = fp8.fp8_matmul(x, w)
    qx, qw = fp8._cast_e4m3(x, sx), fp8._cast_e4m3(w, sw)
    plain = ((qx.float() @ qw.float()) * (sx * sw)).to(x.dtype)

    def rule(got, want, abs_sum=None):
        got, want = got.float(), want.float()
        err = (got - want).abs()
        if abs_sum is None:
            tol = BF16_ULP * want.abs() + 1e-5 * want.abs().max()
            return {"max_abs_err": err.max().item(),
                    "err_over_tol": (err / tol).max().item()}
        tol = BF16_ULP * want.abs() + 2.0 ** -10 * abs_sum
        return {"max_abs_err": err.max().item(),
                "err_over_tol": (err / tol).max().item(),
                "max_err_over_abs_sum": (err / abs_sum.clamp_min(1e-30))
                .max().item()}

    abs_sum = (qx.float().abs() @ qw.float().abs()) * (sx * sw)
    fwd = rule(out, plain, abs_sum)
    del abs_sum
    assert fwd["err_over_tol"] <= 1, fwd
    # The backward at 8192 tokens.
    xs = x[:8192].clone().requires_grad_()
    ws = w.clone().requires_grad_()
    g = torch.randn((8192, n), generator=gen, device="cuda",
                    dtype=torch.bfloat16) * 1e-3
    fp8.fp8_matmul(xs, ws).backward(g)
    sxs = fp8._scale_for(xs.detach().abs().amax())
    qxs, mx = fp8._cast_and_mask(xs.detach(), sxs)
    qws, mw = fp8._cast_and_mask(w, sw)
    want_dx = ((g.float() @ qws.float().t()) * sw * mx).to(torch.bfloat16)
    want_dw = (qxs.float().t() @ g.float()) * sxs * mw
    bwd = {"dx": rule(xs.grad, want_dx), "dw": rule(ws.grad, want_dw)}
    assert all(v["err_over_tol"] <= 1 for v in bwd.values()), bwd
    del xs, ws, g, qxs, mx, mw, want_dx, want_dw

    w16 = w.to(torch.bfloat16)
    qw_col = qw.t().contiguous().t()
    flops = 2.0 * m * k * n
    times = {
        "scaled_mm": cuda_ms_stats(lambda: torch._scaled_mm(
            qx, qw_col, scale_a=sx, scale_b=sw, out_dtype=torch.bfloat16)),
        "fp8_matmul": cuda_ms_stats(lambda: fp8.fp8_matmul(x, w)),
        "bf16_matmul": cuda_ms_stats(lambda: x @ w16)}
    bounds = {"scaled_mm": flops / PEAK_FP8_FLOPS * 1e3,
              "bf16_matmul": flops / PEAK_BF16_FLOPS * 1e3}
    del x, w, w16, qx, qw, qw_col, out, plain
    _free()

    # The LM in turns: off, fp8, fp8, off (2 steps a turn).
    from horovod_tpu_torch.models import transformer_init

    for knob in ("HVDT_FLASH_ATTENTION", "HVDT_FLASH_SMALLSEQ_HB",
                 "HVDT_FLASH_BWD"):
        os.environ.pop(knob, None)
    os.environ["HVDT_FLASH_SMALLSEQ"] = "on"
    cfg = lm_config(SS_SEQ)
    model = transformer_init(0, cfg, device=gen.device)
    opt = hvd.DistributedOptimizer(
        hvd.fused_adam(model.parameters(), 3e-4, weight_decay=1e-4))
    tokens = torch.randint(0, cfg.vocab, (SS_BATCH, SS_SEQ), generator=gen,
                           device=gen.device)
    turns = {"off": [], "matmul": []}
    losses = {"off": [], "matmul": []}
    try:
        for mode in ("off", "matmul", "matmul", "off"):
            os.environ["HVDT_FP8"] = mode
            reset_counters()
            ts, ls = run_lm_steps(model, opt, tokens, cfg, 2)
            launches = counters()
            assert launches["_smallseq_fwd_kernel"] == 2 * 48, launches
            assert launches["_smallseq_bwd_kernel"] == 2 * 24, launches
            assert all(math.isfinite(v) for v in ls), (mode, ls)
            turns[mode] += ts
            losses[mode] += ls
    finally:
        os.environ.pop("HVDT_FP8", None)
        del os.environ["HVDT_FLASH_SMALLSEQ"]
    # Where each step's device time goes (torch.profiler, one steady
    # step of each, after the turns).
    profiles = {}
    from horovod_tpu_torch.models import transformer_loss

    def lm_step():
        opt.zero_grad()
        transformer_loss(model, tokens, cfg).backward()
        opt.step()

    os.environ["HVDT_FLASH_SMALLSEQ"] = "on"
    try:
        for mode in ("off", "matmul"):
            os.environ["HVDT_FP8"] = mode
            summary, _ = step_profile(lm_step, steps=1)
            profiles[mode] = {k: summary[k] for k in (
                "device_ms_per_step", "idle_share",
                "kernel_launches_per_step", "kernel_ms_per_step_by_class",
                "top_kernels")}
            profiles[mode]["top_kernels"] = profiles[mode][
                "top_kernels"][:6]
    finally:
        os.environ.pop("HVDT_FP8", None)
        del os.environ["HVDT_FLASH_SMALLSEQ"]
    tokens_per_step = SS_BATCH * SS_SEQ
    rate = {mode: tokens_per_step / min(ts) for mode, ts in turns.items()}
    del model, opt, tokens
    _free()
    emit({"phase": "fp8", "shape_mkn": list(FP8_MKN),
          "operand_bits_differing": bits, "forward_vs_plain": fwd,
          "backward_vs_plain": bwd, "ms": times, "bound_ms": bounds,
          "bound_by": "operations",
          "lm": {"model": "bert-large", "seq": SS_SEQ, "batch": SS_BATCH,
                 "step_s": turns, "losses": losses, "tokens_per_s": rate,
                 "fp8_over_bf16": rate["matmul"] / rate["off"],
                 "profile": profiles},
          "wall_s": time.perf_counter() - t0, "card": smi})


def _overlap_env(on: bool):
    from horovod_tpu_torch.ops import overlap

    if on:
        os.environ["HVDT_OVERLAP"] = "on"
    else:
        os.environ.pop("HVDT_OVERLAP", None)
    overlap.reset()


def _drop(opt):
    """Unregister an overlapped optimizer's hooks (under any wrapper)."""
    while opt is not None and not isinstance(opt, torch.optim.Optimizer):
        hooked = vars(opt).get("_hooked")
        if hooked is not None:
            hooked.remove()
        opt = vars(opt).get("optimizer")


def _pipelined_run(hvd, batches, calls, graphed):
    from horovod_tpu_torch.models import ResNetConfig, resnet50_init
    from horovod_tpu_torch.ops import overlap
    from horovod_tpu_torch.step_pipeline import donated_step

    model = resnet50_init(0, ResNetConfig())
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = overlap.pipelined_sgd(model.parameters(), 0.01, momentum=0.9,
                                threshold_bytes=OVERLAP_THRESHOLD)
    step = donated_step(_resnet_step) if graphed else _resnet_step
    losses = [step(model, opt, *batches[i % len(batches)]).clone()
              for i in range(calls)]
    torch.cuda.synchronize()
    return model, opt, step, _state_of(model, opt, losses)


def phase_overlap(hvd, smi):
    """overlap (the NCCL world of one): the bs-64 ResNet-50 step graphed
    with HVDT_OVERLAP=on at 8 MiB buckets (hooks issue each bucket on the
    communication stream during the backward; the capture holds the
    fork and the join) against the monolithic graphed step, bit for bit
    (a world of one's sum is a copy); pipelined_sgd graphed against the
    monolithic step, bit for bit, with #2's launches a replay (one a
    bucket); the int8 and int4 wires with error feedback, overlapped and
    graphed against eager, with #5-#8 launches a replay against the
    overlap plan; the graphed step's ms with and without overlap, in
    turns."""
    from horovod_tpu_torch.ops import overlap

    t0 = time.perf_counter()
    os.environ["HVDT_FUSED_CONV1X1"] = "1"
    os.environ["HVDT_FUSION_THRESHOLD"] = str(OVERLAP_THRESHOLD)
    torch.backends.cudnn.deterministic = True
    batch = [_bf16_batch(17, BATCH)]
    try:
        _overlap_env(False)
        mm, mo, ms_, mono = _dp_run(hvd, True, batch, DP_STEPS)
        _overlap_env(True)
        overlap.reset_accounting()
        reset_counters()
        om, oo, os_, ovl = _dp_run(hvd, True, batch, DP_STEPS)
        launches = counters()
        buckets = len(oo._hooked.plan)
        err = _runs_err(ovl, mono)
        assert err == 0.0, err
        kern = replay_kernels(lambda: os_(om, oo, *batch[0]))
        assert kern["_sgd_kernel"] == 1, kern
        ms = {"monolithic": [], "overlapped": []}
        for name in ("monolithic", "overlapped", "overlapped",
                     "monolithic"):
            ms[name].append(_graphed_ms(
                (lambda: ms_(mm, mo, *batch[0])) if name == "monolithic"
                else (lambda: os_(om, oo, *batch[0])), steps=5))
        fraction = overlap.overlap_fraction()
        schedule = overlap.last_schedule()
        _drop(oo)
        del mm, mo, ms_, om, oo, os_
        _free()

        _overlap_env(False)
        reset_counters()
        pm, po, ps_, pipe = _pipelined_run(hvd, batch, DP_STEPS, True)
        p_err = _runs_err(pipe, {k: v for k, v in mono.items()})
        assert p_err == 0.0, p_err
        p_kern = replay_kernels(lambda: ps_(pm, po, *batch[0]))
        p_buckets = len(overlap.overlap_schedule(
            list(pm.parameters()), OVERLAP_THRESHOLD))
        assert p_kern["_sgd_kernel"] == p_buckets, (p_kern, p_buckets)
        del pm, po, ps_
        _free()

        _overlap_env(True)
        wires = {}
        for wire in ("int8", "int4"):
            wm, wo, ws_, wired = _dp_run(hvd, True, batch, DP_STEPS,
                                         wire=wire)
            em, eo, _, eager = _dp_run(hvd, False, batch, DP_STEPS,
                                       wire=wire)
            w_err = _runs_err(wired, eager)
            assert w_err == 0.0, (wire, w_err)
            w_kern = replay_kernels(lambda: ws_(wm, wo, *batch[0]))
            leaves = len(list(wm.parameters()))
            nb = len(wo.optimizer._hooked.plan)
            # Error feedback quantizes and dequantizes every leaf; each
            # bucket is quantized twice and dequantized once (twice on
            # the int4 wire, whose accumulate dequantizes through #8).
            want = (leaves + 2 * nb,
                    leaves + (2 if wire == "int4" else 1) * nb)
            q, dq = (("_quant4_kernel", "_dequant4_kernel")
                     if wire == "int4" else
                     ("_quant_kernel", "_dequant_kernel"))
            assert (w_kern[q], w_kern[dq]) == want, (wire, w_kern, want)
            wires[wire] = {"graphed_vs_eager_max_abs_err": w_err,
                           "buckets": nb,
                           "expected_quant_dequant_per_replay": list(want),
                           "kernels_per_replay": w_kern}
            _drop(wo)
            _drop(eo)
            del wm, wo, ws_, em, eo
            _free()
    finally:
        _overlap_env(False)
        del os.environ["HVDT_FUSION_THRESHOLD"]
        torch.backends.cudnn.deterministic = False
    emit({"phase": "overlap", "model": "resnet50", "batch": BATCH,
          "steps": DP_STEPS, "threshold_bytes": OVERLAP_THRESHOLD,
          "buckets": buckets, "overlap_fraction": fraction,
          "schedule": schedule, "overlapped_vs_monolithic_max_abs_err": err,
          "launches": launches, "kernels_per_replay": kern,
          "step_ms": ms,
          "pipelined_sgd": {"vs_monolithic_max_abs_err": p_err,
                            "buckets": p_buckets,
                            "kernels_per_replay": p_kern},
          "wires_overlapped": wires,
          "tolerance": 0.0, "wall_s": time.perf_counter() - t0,
          "card": smi})


# ---- ZeRO, checkpoints and the autotuner (slice 15) -----------------------

def _zero_opt(hvd, model, kind, stage, wire=None):
    """DistributedOptimizer over fused_sgd(0.01, momentum 0.9) ("sgd") or
    fused_adam(1e-3, weight_decay=1e-4) ("adam"), ZeRO ``stage`` (None:
    replicated); ``wire`` "int8" adds the int8 wire under error
    feedback."""
    inner = (hvd.fused_sgd(model.parameters(), 0.01, momentum=0.9)
             if kind == "sgd" else
             hvd.fused_adam(model.parameters(), 1e-3, weight_decay=1e-4))
    opt = hvd.DistributedOptimizer(
        inner, zero=stage or "off",
        compression=hvd.Compression.int8 if wire else hvd.Compression.none)
    return hvd.quant.with_error_feedback(opt, wire=wire) if wire else opt


def _zero_step(model, opt, images, labels):
    """The ResNet step; a ZeRO "params" optimizer writes the full
    parameters first (a "states" one has nothing to write)."""
    gather = getattr(opt, "gather_params", None)
    if gather is not None:
        gather()
    return _resnet_step(model, opt, images, labels)


def _zero_inner(opt):
    """The DistributedOptimizer under any wrapper."""
    while "_op" not in vars(opt):
        opt = opt.optimizer
    return opt


def _zero_state_of(model, opt, losses) -> dict:
    """The losses, the model's state and the moments by leaf: a ZeRO
    optimizer's whole state (gathered) or the replicated optimizer's,
    under the same keys."""
    dopt = _zero_inner(opt)
    if hasattr(dopt, "transform"):
        dopt.gather_params()         # "params": the rows are the truth
    out = {"losses": torch.stack(losses)}
    out.update({k: v.detach().clone() for k, v in model.state_dict().items()})
    if hasattr(dopt, "transform"):
        full = dopt.transform.full_state(dopt.gathered_zero_state(),
                                         dopt._zparams)
        for name in ("mu", "nu", "trace"):
            for i, v in enumerate(full.get(name, [])):
                out[f"{name}{i}"] = v.clone()
    else:
        params = [p for g in dopt.optimizer.param_groups for p in g["params"]]
        for i, p in enumerate(params):
            for name, v in dopt.optimizer.state[p].items():
                if isinstance(v, torch.Tensor):
                    out[f"{name}{i}"] = v.clone()
    return out


def _zero_run(hvd, kind, stage, batches, calls, *, graphed=True, bn_axis=None,
              wire=None):
    """``calls`` steps of a fresh ResNet-50 under :func:`_zero_opt`.
    Returns (model, opt, step, state from :func:`_zero_state_of`); the
    optimizer's bytes on the card (``memory_allocated`` across its
    construction) are ``opt.hvdt_alloc_bytes``."""
    from horovod_tpu_torch.models import ResNetConfig, resnet50_init
    from horovod_tpu_torch.step_pipeline import donated_step

    model = resnet50_init(0, ResNetConfig(bn_axis=bn_axis))
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    opt = _zero_opt(hvd, model, kind, stage, wire)
    torch.cuda.synchronize()
    opt.hvdt_alloc_bytes = torch.cuda.memory_allocated() - base
    step = donated_step(_zero_step) if graphed else _zero_step
    losses = [step(model, opt, *batches[i % len(batches)]).clone()
              for i in range(calls)]
    torch.cuda.synchronize()
    return model, opt, step, _zero_state_of(model, opt, losses)


def _state_err(got: dict, want: dict) -> dict:
    """Largest absolute difference of the parameters and BN state, and of
    the moments, between two runs (0 when every byte agrees)."""
    assert got.keys() == want.keys(), (sorted(got)[:5], sorted(want)[:5])
    moments = [k for k in got if k[:2] in ("mu", "nu", "tr")]
    rest = [k for k in got if k not in moments]
    return {"params_and_stats": max(_bit_err(got[k], want[k]) for k in rest),
            "moments": max((_bit_err(got[k], want[k]) for k in moments),
                           default=0.0)}


REPLAY_OPTIM = {"sgd": "_sgd_kernel", "adam": "_adam_kernel"}


def phase_zero(hvd, smi):
    """zero (the NCCL world of one, where ZeRO's layout is unbound: one
    shard, no collective): the bs-64 ResNet-50 step graphed under
    DistributedOptimizer(zero=grads|states|params) with fused_sgd and with
    fused_adam against the replicated graphed step from the same state,
    parameters, BN statistics and moments bit for bit; #1/#2 once a
    replay (torch.profiler); each ZeRO step's ms against the replicated
    step's, in turns."""
    t0 = time.perf_counter()
    os.environ["HVDT_FUSED_CONV1X1"] = "1"
    torch.backends.cudnn.deterministic = True
    batch = [_bf16_batch(23, BATCH)]
    rows = {}
    try:
        for kind in ("sgd", "adam"):
            rm, ro, rs_, want = _zero_run(hvd, kind, None, batch, DP_STEPS)
            for stage in ("grads", "states", "params"):
                reset_counters()
                zm, zo, zs_, got = _zero_run(hvd, kind, stage, batch,
                                             DP_STEPS)
                launches = counters()
                assert launches[REPLAY_OPTIM[kind]] >= 2, (kind, stage,
                                                           launches)
                err = _state_err(got, want)
                assert err == {"params_and_stats": 0.0, "moments": 0.0}, (
                    kind, stage, err)
                kern = replay_kernels(lambda: zs_(zm, zo, *batch[0]))
                assert kern[REPLAY_OPTIM[kind]] == 1, (kind, stage, kern)
                ms = {"replicated": [], "zero": []}
                for name in ("zero", "replicated", "replicated", "zero"):
                    ms[name].append(_graphed_ms(
                        (lambda: rs_(rm, ro, *batch[0]))
                        if name == "replicated"
                        else (lambda: zs_(zm, zo, *batch[0])), steps=5))
                dopt = _zero_inner(zo)
                rows[f"{kind}.{stage}"] = {
                    "max_abs_err_vs_replicated": err,
                    "launches": {k: v for k, v in launches.items() if v},
                    "kernels_per_replay": kern, "step_ms": ms,
                    "state_bytes": (dopt.transform.state_bytes_per_rank(
                        dopt._zparams) if hasattr(dopt, "transform")
                        else None)}
                del zm, zo, zs_
                _free()
            del rm, ro, rs_
            _free()
    finally:
        torch.backends.cudnn.deterministic = False
    emit({"phase": "zero", "model": "resnet50", "batch": BATCH,
          "steps": DP_STEPS, "world": 1, "layout": "unbound",
          "runs": rows, "tolerance": 0.0,
          "wall_s": time.perf_counter() - t0, "card": smi})


def phase_ckpt(hvd, smi):
    """ckpt (world of one): the bs-64 ResNet-50 step graphed under
    DistributedOptimizer(fused_adam(...), zero="states").  After 2 steps
    the model's state (checkpoint.CheckpointManager) and the ZeRO state
    (save_zero_state) are saved; the stall of a sync save and of
    save_async (the host snapshot) is timed; the async snapshot, taken
    before a step that updates the tensors in place, restores to the
    snapshot's values.  The step then runs 2 more replays; restoring
    both checkpoints in place (the captured storages) and replaying
    again gives the same state bit for bit."""
    import shutil
    import tempfile

    from horovod_tpu_torch import checkpoint as ckpt

    t0 = time.perf_counter()
    os.environ["HVDT_FUSED_CONV1X1"] = "1"
    torch.backends.cudnn.deterministic = True
    batch = [_bf16_batch(29, BATCH)]
    root = tempfile.mkdtemp(prefix="chip-smoke-ckpt-")
    prev = os.environ.pop("HVDT_ASYNC_CKPT", None)
    try:
        reset_counters()
        model, opt, step, _ = _zero_run(hvd, "adam", "states", batch, 2)
        launches = counters()
        assert launches["_adam_kernel"] >= 2, launches   # eager, capture
        tree = model.state_dict()
        mgr = ckpt.CheckpointManager(os.path.join(root, "sync"))
        stall = {"sync": [], "async": []}
        for i in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            mgr.save(10 + i, tree, force=True)
            stall["sync"].append((time.perf_counter() - t) * 1e3)
        ckpt.save_zero_state(os.path.join(root, "zero"),
                             opt.gathered_zero_state(), opt.zero_metadata(),
                             step=12)
        os.environ["HVDT_ASYNC_CKPT"] = "1"
        amgr = ckpt.CheckpointManager(os.path.join(root, "async"))
        before = {k: v.detach().clone() for k, v in tree.items()}
        for i in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            amgr.save_async(20 + i, tree, force=True)
            stall["async"].append((time.perf_counter() - t) * 1e3)
            if i == 0:
                # The next replay rewrites every parameter in place while
                # the writer may still be serializing.
                step(model, opt, *batch[0])
                torch.cuda.synchronize()
                assert amgr.wait_for_async(120)
                snap, snap_step = amgr.restore_latest()
                assert snap_step == 20, snap_step
                snap_err = max(_bit_err(snap[k], before[k].cpu())
                               for k in before)
                assert snap_err == 0.0, snap_err
                moved = max(_bit_err(tree[k].detach(), before[k])
                            for k in before)
                assert moved > 0.0
        assert amgr.wait_for_async(120)
        amgr.close()
        assert amgr.last_good_step() == 22

        # Restore into the captured step: replays continue bit for bit.
        mgr.save(30, tree, force=True)
        ckpt.save_zero_state(os.path.join(root, "zero30"),
                             opt.gathered_zero_state(), opt.zero_metadata(),
                             step=30)
        ptrs = [t.data_ptr() for t in tree.values()]
        losses = [step(model, opt, *batch[0]).clone() for _ in range(2)]
        want = _zero_state_of(model, opt, losses)
        restored, rstep = mgr.restore_latest(tree, in_place=True)
        zstate, zmeta, zstep = ckpt.restore_zero_state(
            os.path.join(root, "zero30"))
        assert (rstep, zstep) == (30, 30) and zmeta == opt.zero_metadata()
        opt.load_zero_state(zstate)
        assert [t.data_ptr() for t in model.state_dict().values()] == ptrs
        losses = [step(model, opt, *batch[0]).clone() for _ in range(2)]
        got = _zero_state_of(model, opt, losses)
        err = _state_err(got, want)
        loss_err = _bit_err(got["losses"], want["losses"])
        assert err == {"params_and_stats": 0.0, "moments": 0.0}, err
        assert loss_err == 0.0, loss_err
        nbytes = sum(os.path.getsize(os.path.join(dp, f))
                     for dp, _, fs in os.walk(mgr.step_path(30)) for f in fs)
        zbytes = sum(os.path.getsize(os.path.join(root, "zero30", f))
                     for f in os.listdir(os.path.join(root, "zero30")))
        del model, opt, step, tree, restored, before, snap
        _free()
    finally:
        torch.backends.cudnn.deterministic = False
        if prev is None:
            os.environ.pop("HVDT_ASYNC_CKPT", None)
        else:
            os.environ["HVDT_ASYNC_CKPT"] = prev
        shutil.rmtree(root, ignore_errors=True)
    emit({"phase": "ckpt", "model": "resnet50", "batch": BATCH,
          "optimizer": "fused_adam, zero=states",
          "checkpoint_stall_ms": stall, "model_checkpoint_bytes": nbytes,
          "launches": {k: v for k, v in launches.items() if v},
          "zero_checkpoint_bytes": zbytes,
          "async_snapshot_vs_before_step_max_abs_err": snap_err,
          "restored_replays_vs_uninterrupted": {**err, "losses": loss_err},
          "note": "warm page cache: the files were just written",
          "wall_s": time.perf_counter() - t0, "card": smi})


AUTOTUNE_ENV = {"HVDT_AUTOTUNE": "1", "HVDT_AUTOTUNE_OVERLAP": "1",
                "HVDT_AUTOTUNE_ZERO": "1",
                "HVDT_AUTOTUNE_WARMUP_SAMPLES": "1",
                "HVDT_AUTOTUNE_STEPS_PER_SAMPLE": "3",
                "HVDT_AUTOTUNE_BAYES_OPT_MAX_SAMPLES": "4"}


def phase_autotune(hvd, smi):
    """autotune (world of one): autotune.autotuned_step with
    HVDT_AUTOTUNE=1 over the bucket, overlap and ZeRO dimensions, the
    bs-64 ResNet-50 step under DistributedOptimizer(fused_sgd(...),
    zero="states").  Each knob change rebuilds the step as a fresh
    donated_step (a new capture; the old graph is dropped) over the same
    optimizer and state: overlap through set_overlap, the ZeRO leg
    through set_rs_wire (the reduce-scatter or the allreduce-and-slice
    wire).  In a world of one the legs give the same values, so the
    tuned run's state equals an untuned run's bit for bit; the line
    holds the samples, the rebuilds and the final knobs."""
    from horovod_tpu_torch import autotune
    from horovod_tpu_torch.step_pipeline import donated_step

    t0 = time.perf_counter()
    os.environ["HVDT_FUSED_CONV1X1"] = "1"
    torch.backends.cudnn.deterministic = True
    batch = _bf16_batch(31, BATCH)
    calls = 24
    saved = {k: os.environ.get(k) for k in AUTOTUNE_ENV}
    os.environ.update(AUTOTUNE_ENV)
    try:
        from horovod_tpu_torch.models import ResNetConfig, resnet50_init

        model = resnet50_init(0, ResNetConfig())
        hvd.broadcast_parameters(model.state_dict(), root_rank=0)
        opt = _zero_opt(hvd, model, "sgd", "states")
        built = []

        def builder(threshold_bytes, overlap=False, zero=True):
            opt.set_overlap(overlap)
            opt.set_rs_wire(zero)
            built.append({"threshold_bytes": threshold_bytes,
                          "overlap": bool(overlap), "zero": bool(zero)})
            return donated_step(_zero_step)

        step = autotune.autotuned_step(builder,
                                       tree_example=list(model.parameters()))
        reset_counters()
        losses = [step(model, opt, *batch).clone() for _ in range(calls)]
        torch.cuda.synchronize()
        launches = counters()
        # Each build's first call runs eagerly and its second captures
        # (the last build, made after the last sample, runs no call).
        assert launches["_sgd_kernel"] >= 2 * (len(built) - 1), (
            launches, built)
        got = _zero_state_of(model, opt, losses)
        tuner = step.autotuner
        summary = step.summary()
        pm = tuner.pm
        final = {"bucket_bytes": pm.bucket_bytes,
                 "overlap": pm.overlap_schedule, "zero": pm.zero_sharding}
        samples = pm._samples_done
        opt.set_overlap(False)
        del step, model, opt
        _free()
        for k in AUTOTUNE_ENV:
            os.environ.pop(k, None)
        _, _, _, want = _zero_run(hvd, "sgd", "states", [batch], calls)
        err = _state_err(got, want)
        assert err == {"params_and_stats": 0.0, "moments": 0.0}, err
        assert len(built) >= 2 and samples >= 1, (built, samples)
        _free()
    finally:
        torch.backends.cudnn.deterministic = False
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    emit({"phase": "autotune", "model": "resnet50", "batch": BATCH,
          "calls": calls, "env": AUTOTUNE_ENV, "samples": samples,
          "launches": {k: v for k, v in launches.items() if v},
          "rebuilds": len(built) - 1, "builds": built, "final": final,
          "summary": summary, "tuned_vs_untuned_max_abs_err": err,
          "wall_s": time.perf_counter() - t0, "card": smi})


# ---- the interop phase: Horovod's torch API ----------------------------------

INTEROP_BATCH = 128
INTEROP_STEPS = 3
# The interop SyncBatchNorm's synchronized function against
# torch.nn.functional.batch_norm on the card, relative L2 of the output
# and of the input gradient: in f32 the f64 statistics against cuDNN's
# (rounding only); in bf16 the normalisation in bf16 against cuDNN's f32
# arithmetic rounded once (a few bf16 ulps, 2^-8 each).
INTEROP_BN_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
INTEROP_BN_SHAPE = (INTEROP_BATCH, 256, 56, 56)


def _interop_opt(hvd, model, optim="sgd", **kw):
    """interop.torch.DistributedOptimizer over fused_sgd(0.01, momentum
    0.9) or fused_adam(1e-3), with the model's parameter names."""
    import horovod_tpu_torch.interop.torch as ihvd

    inner = (hvd.fused_sgd(model.parameters(), 0.01, momentum=0.9)
             if optim == "sgd" else hvd.fused_adam(model.parameters(), 1e-3))
    return ihvd.DistributedOptimizer(
        inner, named_parameters=model.named_parameters(), **kw)


def _fused_opt(hvd, model):
    return hvd.DistributedOptimizer(
        hvd.fused_sgd(model.parameters(), 0.01, momentum=0.9))


def _timed_calls(obj, name, spent):
    """Wrap ``obj.name`` (an instance attribute shadowing the method) so
    each call's host seconds are appended to ``spent``."""
    fn = getattr(obj, name)

    def wrapper(*args):
        t0 = time.perf_counter()
        try:
            return fn(*args)
        finally:
            spent.append(time.perf_counter() - t0)

    setattr(obj, name, wrapper)


def _step_times(model, opt, batches, steps):
    """Host seconds of ``steps`` eager ResNet-50 steps (each ended by a
    synchronize) and their losses."""
    times, losses = [], []
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(_resnet_step(model, opt, *batches[i % len(batches)]))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return times, losses


def _interop_sync_bn(gen):
    """The interop SyncBatchNorm in the world of one, in f32 and bf16: the
    module (plain _BatchNorm there) against nn.BatchNorm2d bit for bit,
    and its synchronized function (the statistics summed by a named eager
    allreduce, in f64 on the card) against F.batch_norm: output and input
    gradient by relative L2, dtype kept, forward ms of each."""
    from horovod_tpu_torch.interop import torch_sync_batch_norm as tsbn

    out = {}
    c = INTEROP_BN_SHAPE[1]
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn(INTEROP_BN_SHAPE, generator=gen,
                        device="cuda").to(dtype)
        mod = tsbn.SyncBatchNorm(c).to("cuda", dtype)
        plain = torch.nn.BatchNorm2d(c).to("cuda", dtype)
        same = _bit_err(mod(x), plain(x)) == 0.0 and _bit_err(
            mod.running_var, plain.running_var) == 0.0
        w = torch.rand(c, generator=gen, device="cuda").to(dtype) + 0.5
        b = torch.randn(c, generator=gen, device="cuda").to(dtype)
        xs = x.clone().requires_grad_()
        y, _, _, count = tsbn._SyncBNFunction.apply(xs, w, b, 1e-5)
        xr = x.clone().requires_grad_()
        ref = torch.nn.functional.batch_norm(xr, None, None, w, b, True,
                                             0.0, 1e-5)
        dy = torch.randn(y.shape, generator=gen, device="cuda").to(dtype)
        gx, = torch.autograd.grad(y, xs, dy)
        gr, = torch.autograd.grad(ref, xr, dy)
        row = {"module_equals_batchnorm2d": same,
               "out_rel_l2": _rel_l2([y.detach()], [ref.detach()]),
               "dx_rel_l2": _rel_l2([gx], [gr]),
               "dtype_kept": y.dtype == dtype and gx.dtype == dtype,
               "count": float(count), "tolerance": INTEROP_BN_TOL[dtype],
               "sync_forward_ms": cuda_ms(lambda: tsbn._SyncBNFunction.apply(
                   x, w, b, 1e-5), iters=5, reps=3),
               "batch_norm_forward_ms": cuda_ms(
                   lambda: torch.nn.functional.batch_norm(
                       x, None, None, w, b, True, 0.0, 1e-5), iters=5,
                   reps=3)}
        assert same and row["dtype_kept"], row
        assert row["count"] == x.numel() / c, row
        assert row["out_rel_l2"] <= INTEROP_BN_TOL[dtype], row
        assert row["dx_rel_l2"] <= INTEROP_BN_TOL[dtype], row
        out[str(dtype).split(".")[1]] = row
        del x, xs, xr, y, ref, gx, gr, dy, mod, plain
        _free()
    return out


def _interop_timeline(hvd, batches):
    """One interop step with HVDT_TIMELINE set (the controller restarted
    so it reads the variable): the JSON parses, and every grad.<name>
    row holds NEGOTIATE_ALLREDUCE then EXEC_ALLREDUCE."""
    import tempfile

    from horovod_tpu_torch.models import ResNetConfig, resnet50_init
    from horovod_tpu_torch.ops import eager

    path = os.path.join(tempfile.mkdtemp(prefix="hvdt_timeline_"),
                        "timeline.json")
    model = resnet50_init(0, ResNetConfig())
    opt = _interop_opt(hvd, model)
    os.environ["HVDT_TIMELINE"] = path
    eager.shutdown_controller()
    try:
        times, _ = _step_times(model, opt, batches, INTEROP_STEPS)
    finally:
        opt._hvdt.remove()
        eager.shutdown_controller()
        hvd.stop_timeline()
        del os.environ["HVDT_TIMELINE"]
    with open(path) as f:
        events = json.load(f)
    names = {e["pid"]: e["args"]["name"] for e in events if e["ph"] == "M"}
    rows = {}
    for e in events:
        if e["ph"] == "B":
            rows.setdefault(names[e["pid"]], []).append(e["name"])
    grads = [f"grad.{n}" for n, _ in model.named_parameters()]
    pattern = ["NEGOTIATE_ALLREDUCE", "EXEC_ALLREDUCE"] * INTEROP_STEPS
    whole = all(rows.get(n) == pattern for n in grads)
    assert whole, {n: rows.get(n) for n in grads[:3]}
    os.remove(path)
    del model, opt
    _free()
    return {"events": len(events), "tensors": len(names),
            "grad_rows_whole": whole, "step_s": times}


def phase_interop(hvd, smi):
    """interop (the NCCL world of one; see the module docstring).
    Returns the launches of #2 (the interop step) and of #1, #5, #6 (the
    int8 steps)."""
    from horovod_tpu_torch.models import (ResNetConfig, resnet50_init,
                                          resnet_loss)
    from horovod_tpu_torch.quant import kernels as qk

    t0 = time.perf_counter()
    os.environ["HVDT_FUSED_CONV1X1"] = "1"
    torch.backends.cudnn.deterministic = True
    gen = torch.Generator(device="cuda").manual_seed(16)
    batches = [_bf16_batch(300 + i, INTEROP_BATCH)
               for i in range(INTEROP_STEPS)]
    try:
        # The interop optimizer against the port's own, bit for bit (a
        # world of one reduces nothing; both step #2 on equal gradients).
        model = resnet50_init(0, ResNetConfig())
        opt = _interop_opt(hvd, model)
        reset_counters()
        _, losses = _step_times(model, opt, batches, INTEROP_STEPS)
        sgd_launches = counters()
        leaves = [p for p in model.parameters() if p.requires_grad]
        assert len(leaves) == 161, len(leaves)
        assert sgd_launches["_sgd_kernel"] == INTEROP_STEPS, sgd_launches
        assert sgd_launches["_mm_stats_kernel"] == 26 * INTEROP_STEPS
        got = _state_of(model, opt, losses)
        ref_model = resnet50_init(0, ResNetConfig())
        ref_opt = _fused_opt(hvd, ref_model)
        _, ref_losses = _step_times(ref_model, ref_opt, batches,
                                    INTEROP_STEPS)
        err = _runs_err(got, _state_of(ref_model, ref_opt, ref_losses))
        assert err == 0.0, err

        # Step times in turns (interop, fused, fused, interop), the host
        # time in the 161 hooks and in synchronize() a step against the
        # fused exchange's synchronize().
        hooks, syncs, fused = [], [], []
        _timed_calls(opt._hvdt, "_hook", hooks)
        _timed_calls(opt._hvdt, "synchronize", syncs)
        _timed_calls(ref_opt, "synchronize", fused)
        turns = {"interop": [], "fused": []}
        for name in ("interop", "fused", "fused", "interop"):
            m, o = (model, opt) if name == "interop" else (ref_model,
                                                           ref_opt)
            turns[name] += _step_times(m, o, batches, INTEROP_STEPS)[0]
        n_steps = 2 * INTEROP_STEPS
        assert len(hooks) == 161 * n_steps and len(syncs) == n_steps
        hook_ms = [1e3 * sum(hooks[i * 161:(i + 1) * 161])
                   for i in range(n_steps)]
        steady = {k: _stats(v)["median"] for k, v in turns.items()}
        opt._hvdt.remove()
        del model, opt, ref_model, ref_opt, got
        _free()
        emit({"phase": "interop", "model": "resnet50",
              "batch": INTEROP_BATCH, "image": IMAGE, "steps": INTEROP_STEPS,
              "optimizer": "interop.torch.DistributedOptimizer(fused_sgd)",
              "losses": torch.stack(losses).tolist(),
              "max_abs_err_vs_port_distributed_optimizer": err,
              "launches": {k: v for k, v in sgd_launches.items() if v},
              "step_s": turns, "steady_step_s": steady,
              "images_per_s": {k: INTEROP_BATCH / v
                               for k, v in steady.items()},
              "hooks_host_ms_per_step": _stats(hook_ms),
              "interop_synchronize_host_ms": _stats(
                  [1e3 * s for s in syncs]),
              "fused_synchronize_host_ms": _stats([1e3 * s for s in fused]),
              "named_allreduces_per_step": 161, "card": smi})

        # compression=Compression.int8 over fused_adam: #5/#6 once a float
        # leaf a step in the hooks, #1 once a step; one step's leaves
        # against the plain quantize-dequantize bit for bit.
        model = resnet50_init(0, ResNetConfig())
        opt = _interop_opt(hvd, model, "adam",
                           compression=hvd.Compression.int8)
        reset_counters()
        images, labels = batches[0]
        opt.zero_grad()
        loss, _ = resnet_loss(model, images, labels)
        loss.backward()
        local = [p.grad.detach().clone() for p in model.parameters()]
        opt.synchronize()
        leaf_err = max(_bit_err(p.grad, qk.quantize_dequantize(
            g, use_kernels=False)) for p, g in zip(model.parameters(), local))
        assert leaf_err == 0.0, leaf_err
        with opt.skip_synchronize():
            opt.step()
        times, q_losses = _step_times(model, opt, batches[1:],
                                      INTEROP_STEPS - 1)
        int8_launches = counters()
        n_float = sum(p.is_floating_point() for p in model.parameters())
        want = n_float * INTEROP_STEPS
        assert int8_launches["_quant_kernel"] == want, int8_launches
        assert int8_launches["_dequant_kernel"] == want, int8_launches
        assert int8_launches["_adam_kernel"] == INTEROP_STEPS, int8_launches
        assert all(math.isfinite(float(x)) for x in q_losses)
        opt._hvdt.remove()
        del model, opt, local
        _free()
        emit({"phase": "interop_int8", "steps": INTEROP_STEPS,
              "optimizer": "interop.torch.DistributedOptimizer(fused_adam, "
                           "compression=Compression.int8)",
              "float_leaves": n_float,
              "launches": {k: v for k, v in int8_launches.items() if v},
              "expected_quant_dequant": [want, want],
              "leaves_vs_plain_max_abs_err": leaf_err, "step_s": times,
              "card": smi})

        bn = _interop_sync_bn(gen)
        emit({"phase": "interop_sync_bn", "shape": list(INTEROP_BN_SHAPE),
              **bn, "card": smi})
        tl = _interop_timeline(hvd, batches)
        emit({"phase": "interop_timeline", **tl,
              "wall_s": time.perf_counter() - t0, "card": smi})
    finally:
        torch.backends.cudnn.deterministic = False
    return {"_sgd_kernel": sgd_launches["_sgd_kernel"],
            "_adam_kernel": int8_launches["_adam_kernel"],
            "_quant_kernel": int8_launches["_quant_kernel"],
            "_dequant_kernel": int8_launches["_dequant_kernel"]}


BENCH_BATCH = 128
BENCH_ARGS = ["--num-iters", "3", "--num-batches-per-iter", "20"]
# The legs of the bench phase: (name, bench flags, HVDT_FUSED_CONV1X1).
BENCH_LEGS = {"G": (["--fused-optimizer"], "1"),
              "E": (["--fused-optimizer", "--eager"], "1"),
              "D": ([], "0"),
              "R": (["--remat", "dots"], "0")}


def step_profile(step, steps: int = 5) -> dict:
    """torch.profiler over ``steps`` steady calls of ``step``, summarized
    by :func:`trace_summary`."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return trace_summary(events, steps, wall)


# Kernel classes of a step's device time: the first whose name parts
# match a kernel's name (lowercased) takes it.
KERNEL_CLASSES = (
    ("port kernels", ("mm_stats_kernel", "mm_bn_relu_kernel",
                      "optim_multi", "smallseq_", "flash_")),
    ("nccl", ("nccl",)),
    ("convolutions and matmuls", ("conv", "cudnn", "xmma", "gemm",
                                  "cutlass", "wgrad", "dgrad", "nvjet")),
    ("reductions", ("reduce_kernel",)),
    ("copies and casts", ("copy",)),
    ("elementwise", ("elementwise",)),
)


def trace_summary(events, steps: int, wall_s: float):
    """From a chrome trace of ``steps`` steps: the device's busy and idle
    share of the window from its first activity to its last (kernels,
    copies and fills on any stream, overlaps counted once), the device
    time and host time a step, kernel launches a step, device ms a step
    by :data:`KERNEL_CLASSES`, the top kernels by device time; and a
    function giving the launches a step of the kernels whose name holds a
    string."""
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
                   and "dur" in e)
    assert spans, "the profiler recorded no device activity"
    busy, (lo, hi) = 0.0, spans[0]
    for s0, s1 in spans[1:]:
        if s0 > hi:
            busy, lo = busy + hi - lo, s0
        hi = max(hi, s1)
    busy += hi - lo
    window = hi - spans[0][0]
    kernels = {}
    for e in events:
        if e.get("cat") == "kernel":
            n, t = kernels.get(e["name"], (0, 0.0))
            kernels[e["name"]] = (n + 1, t + e["dur"])
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:12]
    by_class = {}
    for k, (_, t) in kernels.items():
        cls = next((c for c, parts in KERNEL_CLASSES
                    if any(p in k.lower() for p in parts)), "other")
        by_class[cls] = by_class.get(cls, 0.0) + t / 1e3 / steps
    summary = {
        "steps": steps, "window_ms": window / 1e3, "busy_ms": busy / 1e3,
        "busy_share": busy / window, "idle_share": 1.0 - busy / window,
        "device_ms_per_step": busy / 1e3 / steps,
        "host_ms_per_step": wall_s * 1e3 / steps,
        "kernel_launches_per_step": sum(n for n, _ in kernels.values())
        / steps,
        "kernel_ms_per_step_by_class": by_class,
        "top_kernels": [{"name": k[:120], "per_step": n / steps,
                         "ms_per_step": t / 1e3 / steps}
                        for k, (n, t) in top]}
    return summary, lambda sub: sum(
        n for k, (n, _) in kernels.items() if sub in k) / steps


def bench_leg(bench, name: str, smi: str):
    """One leg of the port's bench at full width, through
    horovod_tpu_torch.bench.measure (the child's code): its JSON line,
    per-iteration rates and their spread, peak memory and the kernel
    counters of its run."""
    flags, fused_conv = BENCH_LEGS[name]
    os.environ["HVDT_FUSED_CONV1X1"] = fused_conv
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    leg = bench.measure(bench._parse_args([*BENCH_ARGS, *flags]))
    launches = counters()
    rates = leg.rates
    mean = sum(rates) / len(rates)
    row = {"leg": name, "flags": flags, "HVDT_FUSED_CONV1X1": fused_conv,
           "images_per_s": leg.doc["value"], "rates": rates,
           "spread": (sum((r - mean) ** 2 for r in rates)
                      / len(rates)) ** 0.5,
           "min_rate": min(rates), "max_rate": max(rates),
           "mfu": leg.doc["mfu"], "flops_per_step": leg.doc["flops_per_step"],
           "compile_s": leg.doc["compile_s"],
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": {k: v for k, v in launches.items() if v},
           "json": leg.doc, "card": smi}
    return leg, row


def bench_chaos(bench, smi) -> dict:
    """The bench's chaos-audit mode: leg D (one iteration of 20 steps)
    with HVDT_FAULT_PLAN=exc@step=5,exc@step=15 — the step loop absorbs
    both injected faults and its JSON reports them; the images/s beside
    the leg's without a plan."""
    os.environ["HVDT_FUSED_CONV1X1"] = "0"
    os.environ["HVDT_FAULT_PLAN"] = "exc@step=5,exc@step=15"
    try:
        leg = bench.measure(bench._parse_args(
            ["--num-iters", "1", "--num-batches-per-iter", "20"]))
    finally:
        del os.environ["HVDT_FAULT_PLAN"]
    doc = leg.doc
    assert doc["recovered_faults"] == 2 and doc["injected_faults"] == 2, doc
    assert doc["fault_plan"] == "exc@step=5,exc@step=15", doc
    del leg
    gc.collect()
    torch.cuda.empty_cache()
    return {k: doc[k] for k in ("value", "fault_plan", "recovered_faults",
                                "injected_faults", "emergency_checkpoints")}


def graphed_equals_eager(hvd, make_opt, images, labels, steps: int = 3,
                         before_call=None):
    """Two ResNet-50 copies from one state (broadcast_parameters in the
    NCCL world of one), each under DistributedOptimizer(make_opt(...)):
    ``steps`` steps through donated_step on one, eager steps on the
    other (``before_call(i)``, when given, runs before the graphed copy's
    call i: call 0 is eager, call 1 captures).  The largest difference
    over losses, parameters, BatchNorm running statistics and optimizer
    state (0.0 when every byte is the same), and the number of tensors
    compared."""
    from horovod_tpu_torch.models import ResNetConfig, resnet50_init, \
        resnet_loss
    from horovod_tpu_torch.step_pipeline import donated_step

    def one_step(model, opt, images, labels):
        opt.zero_grad(set_to_none=True)
        loss, _ = resnet_loss(model, images, labels)
        loss.backward()
        opt.step()
        return loss.detach()

    out = []
    for graphed in (True, False):
        model = resnet50_init(0, ResNetConfig())
        hvd.broadcast_parameters(model.state_dict(), root_rank=0)
        opt = hvd.DistributedOptimizer(make_opt(model.parameters()))
        step = donated_step(one_step) if graphed else one_step
        losses = []
        for i in range(steps):
            if graphed and before_call is not None:
                before_call(i)
            losses.append(step(model, opt, images, labels).clone())
        torch.cuda.synchronize()
        inner = opt.optimizer
        tensors = [torch.stack(losses), *model.state_dict().values(),
                   *(v for st in inner.state.values() for v in st.values())]
        out.append((tensors, inner.state_dict()["param_groups"],
                    opt._passes))
        del model, opt, step, inner
    (got, got_groups, got_passes), (want, want_groups, want_passes) = out
    assert got_groups == want_groups and got_passes == want_passes == steps
    err = max(_bit_err(a, b) for a, b in zip(got, want))
    return err, len(got)


def phase_bench(hvd, smi):
    """The port's bench leg at full width (ResNet-50, 224x224, batch 128,
    bf16 compute, f32 params) in turns G, E, E, G, D; torch.profiler over
    5 steady steps of G and of E; #4 against its plain version at the
    leg's 26 fused-conv shapes; then graphed against eager steps under
    DistributedOptimizer with fused_sgd and fused_adam.  Returns #4's
    largest error there."""
    from horovod_tpu_torch import bench
    from horovod_tpu_torch.models import ResNetConfig

    t0 = time.perf_counter()
    rows, profiles, main_launches = [], {}, None
    for name in ("G", "E", "E", "G", "D", "R"):
        leg, row = bench_leg(bench, name, smi)
        if name == "G" and main_launches is None:
            main_launches = row["launches"]
            assert main_launches.get("_sgd_kernel", 0) >= 1, main_launches
            assert main_launches.get("_mm_stats_kernel", 0) >= 1, \
                main_launches
        if name not in profiles:
            prof, launches_of = step_profile(leg.step)
            if name == "G":
                per_step = {"_mm_stats_kernel": launches_of(
                                "mm_stats_kernel"),
                            "_sgd_kernel": launches_of("optim_multi<false>")}
                assert per_step == {"_mm_stats_kernel": 26,
                                    "_sgd_kernel": 1}, per_step
                prof["launches_per_graphed_step"] = per_step
            profiles[name] = prof
            emit({"phase": "bench_profile", "leg": name, **prof,
                  "card": smi})
        emit({"phase": "bench_leg", **row})
        rows.append(row)
        del leg
        gc.collect()
        torch.cuda.empty_cache()

    # #4 against its plain version at the shapes the leg gives it.
    from horovod_tpu_torch.ops import conv_fused as cf

    gen = torch.Generator(device="cuda").manual_seed(4)
    mm_stats = []
    for (m, k, n), count in sorted(fused_conv_shapes(BENCH_BATCH,
                                                     IMAGE).items()):
        a, w = conv_operands(gen, m, k, n)
        err, tol = check_mm_stats(cf, a, w)
        mm_stats.append({"shape": [m, k, n], "per_forward": count,
                         "max_abs_err": err, "tolerance": tol})
        del a, w
        torch.cuda.empty_cache()

    # Graphed equals eager on the main path, with deterministic cuDNN.
    os.environ["HVDT_FUSED_CONV1X1"] = "1"
    torch.backends.cudnn.deterministic = True
    try:
        gen = torch.Generator(device="cuda").manual_seed(3)
        images = torch.randn((BENCH_BATCH, IMAGE, IMAGE, 3), generator=gen,
                             device="cuda", dtype=torch.bfloat16)
        labels = torch.randint(0, ResNetConfig().num_classes, (BENCH_BATCH,),
                               generator=gen, device="cuda")
        checks = {}
        for name, make in (
                ("fused_sgd", lambda ps: hvd.fused_sgd(ps, 0.01,
                                                        momentum=0.9)),
                ("fused_adam", lambda ps: hvd.fused_adam(ps, 1e-3))):
            err, n = graphed_equals_eager(hvd, make, images, labels)
            assert err == 0.0, (name, err)
            checks[name] = {"steps": 3, "tensors": n, "max_abs_err": err}
        del images, labels
    finally:
        torch.backends.cudnn.deterministic = False
    gc.collect()
    torch.cuda.empty_cache()
    chaos = bench_chaos(bench, smi)
    by = {}
    for row in rows:
        by.setdefault(row["leg"], []).append(row["images_per_s"])
    assert rows[-1]["json"]["remat"] == "dots", rows[-1]["json"]
    emit({"phase": "bench", "model": "resnet50", "batch": BENCH_BATCH,
          "image": IMAGE, "order": [r["leg"] for r in rows],
          "images_per_s": by, "graphed_over_eager": [
              g / e for g, e in zip(by["G"], by["E"])],
          "remat_dots_over_default": by["R"][0] / by["D"][0],
          "default_leg_images_per_s": by["D"][0],
          "default_leg_pr13_images_per_s": PR13_LEG_D_IMG_S,
          "chaos_leg": chaos,
          "launches": main_launches, "mm_stats_vs_plain": mm_stats,
          "graphed_equals_eager": checks, "tolerance": 0.0,
          "wall_s": time.perf_counter() - t0, "card": smi})
    return max(r["max_abs_err"] for r in mm_stats)


# ---- slice 20: the telemetry plane on the main path (one card) -------------

# Calls of the graphed DistributedOptimizer step whose collective counters
# must be this many times one eager call's.
TELEMETRY_CALLS = 10
TELEMETRY_KNOBS = ("HVDT_TELEMETRY", "HVDT_TRACE_DIR", "HVDT_FLIGHT_RECORDER",
                   "HVDT_HISTORY", "HVDT_HISTORY_SAMPLE_S",
                   "HVDT_METRICS_PORT")


def _telemetry_knobs(on: bool, trace_dir: str) -> None:
    """Turn the recorders, the tracer, the flight recorder and the history
    on or off, with fresh registries and recorders either way."""
    from horovod_tpu_torch.telemetry import (exporter, flight_recorder,
                                             history, instrument, metrics,
                                             trace)

    values = {"HVDT_TELEMETRY": "1", "HVDT_TRACE_DIR": trace_dir,
              "HVDT_FLIGHT_RECORDER": "1", "HVDT_HISTORY": "1",
              "HVDT_HISTORY_SAMPLE_S": "0", "HVDT_METRICS_PORT": "0"}
    for k in TELEMETRY_KNOBS:
        if on:
            os.environ[k] = values[k]
        else:
            os.environ.pop(k, None)
    exporter.stop_exporter()
    metrics.reset_default_registry()
    for mod in (instrument, trace, flight_recorder, history):
        mod.reset()


def _collective_counts() -> dict:
    """The collective counters of the default registry by label set."""
    from horovod_tpu_torch.telemetry import metrics

    reg = metrics.default_registry()
    out = {}
    for name in ("hvdt_collectives_total", "hvdt_collective_bytes_total"):
        m = reg.get(name)
        out[name] = ({",".join(f"{k}={v}" for k, v in sorted(lb.items())): v
                      for lb, v in m.items()} if m is not None else {})
    return out


def _prometheus_names(text: str) -> list:
    """Metric family names of a Prometheus text page (a summary's _sum
    and _count lines fold into their family)."""
    names = set()
    for ln in text.splitlines():
        if not ln or ln.startswith("#"):
            continue
        name = ln.split("{")[0].split(" ")[0]
        for suffix in ("_sum", "_count"):
            if name.endswith(suffix) and f"# TYPE {name[:-len(suffix)]} " \
                    f"summary" in text:
                name = name[:-len(suffix)]
        names.add(name)
    return sorted(names)


def phase_telemetry(hvd, smi):
    """telemetry — the recorders, the tracer, the flight recorder and the
    history on the main path.  Bench leg G (graphed, #2 and #4), 3 x 20
    steps, in turns without and with HVDT_TELEMETRY=1 HVDT_TRACE_DIR
    HVDT_FLIGHT_RECORDER=1 HVDT_HISTORY=1: img/s of each side, #2/#4
    launches a replay on each side (torch.profiler; must be equal: the
    recorders add no kernel to a replay), and on the telemetry side the
    trace file's train.step spans with consecutive trace ids.  Then the
    DistributedOptimizer(fused_sgd) ResNet-50 step under donated_step
    with the recorders on: after TELEMETRY_CALLS calls (one eager, one
    capture + replay, replays) hvdt_collectives_total and
    hvdt_collective_bytes_total must be TELEMETRY_CALLS x one eager
    call's, and the flight recorder must hold TELEMETRY_CALLS x its
    events; /metrics scraped over HTTP from the exporter, every family
    declared in the catalog; the HBM gauge against
    torch.cuda.memory_allocated(); /timeseries.  Then one eager int8
    step under the recorders: #5/#6 launches and the quantized flight
    events; last, 3 graphed ZeRO states steps over fused_adam (#1): the
    hvdt_optimizer_state_bytes gauge holds the plan's per-rank bytes."""
    import tempfile
    import urllib.request

    from horovod_tpu_torch import bench
    from horovod_tpu_torch.models import ResNetConfig, resnet50_init
    from horovod_tpu_torch.step_pipeline import donated_step
    from horovod_tpu_torch.telemetry import (StepTimer, exporter,
                                             flight_recorder, metrics)

    t0 = time.perf_counter()
    trace_dir = tempfile.mkdtemp(prefix="chip_smoke_trace_")
    legs = []
    try:
        for on in (False, True, True, False):
            _telemetry_knobs(on, trace_dir)
            leg, row = bench_leg(bench, "G", smi)
            _, launches_of = step_profile(leg.step)
            out = {"telemetry": on, "images_per_s": row["images_per_s"],
                   "rates": row["rates"],
                   "launches_per_replay": {
                       "_mm_stats_kernel": launches_of("mm_stats_kernel"),
                       "_sgd_kernel": launches_of("optim_multi<false>")}}
            if on:
                doc = leg.doc["telemetry"]
                with open(doc["trace_file"]) as f:
                    events = json.load(f)["traceEvents"]
                spans = [e for e in events if e["name"] == "train.step"]
                ids = [e["args"]["trace_id"] for e in spans]
                assert ids == [f"step-{k:08d}" for k in range(len(ids))], ids
                assert len(spans) >= 60, len(spans)
                out.update(trace_step_spans=len(spans),
                           trace_ids=[ids[0], ids[-1]],
                           trace_events=len(events),
                           metrics_port=doc.get("metrics_port"),
                           flight_recorder_events=doc.get(
                               "flight_recorder_events"),
                           step_dispatch_ms_p50=1e3 * metrics
                           .default_registry().get(
                               "hvdt_step_dispatch_seconds")
                           .percentiles()[0.5])
            legs.append(out)
            del leg
            _free()
        assert all(x["launches_per_replay"] == legs[0]["launches_per_replay"]
                   for x in legs), legs
        assert legs[0]["launches_per_replay"] == {"_mm_stats_kernel": 26,
                                                  "_sgd_kernel": 1}, legs
        off = [x["images_per_s"] for x in legs if not x["telemetry"]]
        on_ = [x["images_per_s"] for x in legs if x["telemetry"]]
        emit({"phase": "telemetry_bench", "leg": "G", "order": [
            "on" if x["telemetry"] else "off" for x in legs],
            "legs": legs, "images_per_s_off": off, "images_per_s_on": on_,
            "overhead_pct": 100.0 * (1.0 - (sum(on_) / len(on_))
                                     / (sum(off) / len(off))),
            "card": smi})

        # The graphed DistributedOptimizer step: counters per replay.
        _telemetry_knobs(True, trace_dir)
        exp = exporter.maybe_start_exporter(topology=hvd.topology())
        assert exp is not None and exp.port > 0
        os.environ["HVDT_FUSED_CONV1X1"] = "1"
        model = resnet50_init(0, ResNetConfig())
        opt = _fused_opt(hvd, model)
        gen = torch.Generator(device="cuda").manual_seed(20)
        images = torch.randn((BATCH, IMAGE, IMAGE, 3), generator=gen,
                             device="cuda", dtype=torch.bfloat16)
        labels = torch.randint(0, 1000, (BATCH,), generator=gen,
                               device="cuda")
        fr = flight_recorder.get_flight_recorder()
        timer = StepTimer(examples_per_step=BATCH)
        step = donated_step(_resnet_step)
        reset_counters()
        times = []
        for k in range(TELEMETRY_CALLS):
            t1 = time.perf_counter()
            step(model, opt, images, labels)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t1)
            timer.observe(times[-1])
            if k == 0:
                unit = _collective_counts()
                unit_events = len(fr.events())
        assert step.graphed
        got = _collective_counts()
        buckets = len(hvd.device.fused_allreduce_buckets(
            [p for p in model.parameters()], None))
        want = {name: {lb: TELEMETRY_CALLS * v for lb, v in series.items()}
                for name, series in unit.items()}
        assert got == want, (got, want)
        assert sum(unit["hvdt_collectives_total"].values()) == len(
            list(model.parameters())), unit
        assert unit_events == buckets, (unit_events, buckets)
        assert len(fr.events()) == TELEMETRY_CALLS * buckets, len(
            fr.events())
        base = f"http://127.0.0.1:{exp.port}"
        text = urllib.request.urlopen(base + "/metrics", timeout=10).read() \
            .decode()
        names = _prometheus_names(text)
        undeclared = [n for n in names if not metrics.declared_metric(n)]
        assert not undeclared, undeclared
        hbm = metrics.default_registry().get("hvdt_hbm_bytes_in_use").value()
        allocated = torch.cuda.memory_allocated()
        assert hbm == float(allocated), (hbm, allocated)
        series = json.loads(urllib.request.urlopen(
            base + "/timeseries", timeout=10).read())["series"]
        assert len(series["step_time"]) == TELEMETRY_CALLS, series
        # One eager int8 step under the recorders: #5/#6 and the
        # quantized flight events.
        int8_opt = hvd.DistributedOptimizer(
            hvd.fused_sgd(model.parameters(), 0.01, momentum=0.9),
            compression=hvd.Compression.int8)
        reset_counters()
        run_steps(model, int8_opt, images, labels, 1)
        q_launches = counters()
        q_events = [e for e in fr.events() if e["name"] == "quantized.flat"]
        assert q_launches["_quant_kernel"] == 2 * buckets, q_launches
        assert q_launches["_dequant_kernel"] == buckets, q_launches
        assert len(q_events) == buckets, q_events
        assert all(e["wire"] == "int8_blockwise" for e in q_events)
        del int8_opt, opt, model, step
        _free()
        # ZeRO states over fused_adam (#1) under the recorders: the
        # memory gauge holds the plan's per-rank optimizer-state bytes.
        reset_counters()
        zm, zo, zstep, _ = _zero_run(hvd, "adam", "states",
                                     [(images, labels)], 3)
        z_launches = counters()
        dopt = _zero_inner(zo)
        z_bytes = dopt.transform.state_bytes_per_rank(dopt._zparams)
        z_gauge = metrics.default_registry().get(
            "hvdt_optimizer_state_bytes").value()
        assert z_launches["_adam_kernel"] >= 2, z_launches
        assert z_gauge == float(z_bytes), (z_gauge, z_bytes)
        del zm, zo, zstep, dopt
        emit({"phase": "telemetry", "calls": TELEMETRY_CALLS,
              "buckets": buckets,
              "collectives_one_call": unit,
              "collectives_after_calls": got,
              "flight_recorder_events": len(fr.events()),
              "metrics_families": len(names), "metrics_bytes": len(text),
              "hbm_gauge_bytes": hbm, "memory_allocated": allocated,
              "timeseries": sorted(series),
              "step_s": times,
              "int8_launches": {k: v for k, v in q_launches.items() if v},
              "int8_flight_events": [{k: e[k] for k in (
                  "seq", "name", "nbytes", "wire", "path", "status")}
                  for e in q_events],
              "zero_states_launches": {k: v for k, v in z_launches.items()
                                       if v},
              "zero_states_state_bytes_gauge": z_gauge,
              "wall_s": time.perf_counter() - t0, "card": smi})
        del images, labels
    finally:
        _telemetry_knobs(False, trace_dir)
        shutil.rmtree(trace_dir, ignore_errors=True)
        _free()


# ---- slice 17: parallel axes, part 1 (one card) -----------------------------

# One bert-large MoE layer's shape: 32 x 512 tokens, d_model 1024, d_ff
# 4096, 8 experts, capacity factor 1.25.
MOE_T, MOE_D, MOE_F, MOE_E, MOE_CF = 32 * 512, 1024, 4096, 8, 1.25
MOE_LM_BATCH = 32
# The dispatch against float64: a row's error within 2^-6 of its norm
# (bf16 operands; the hidden layer and the output rounded to bf16).
MOE_ROW_TOL = 2.0 ** -6
# Batch of the aten.mm count under none / full / dots (a count that does
# not depend on the batch).
DOTS_COUNT_BATCH = 4


def _moe_layer(gen):
    """bf16 tokens, f32 router logits and one bf16 expert stack."""
    t, d, f, e = MOE_T, MOE_D, MOE_F, MOE_E
    tokens = torch.randn((t, d), generator=gen, device="cuda").to(
        torch.bfloat16)
    router = torch.randn((d, e), generator=gen, device="cuda") * d ** -0.5
    w_up = (torch.randn((e, d, f), generator=gen, device="cuda")
            * d ** -0.5).to(torch.bfloat16)
    w_down = (torch.randn((e, f, d), generator=gen, device="cuda")
              * f ** -0.5).to(torch.bfloat16)
    return tokens, tokens.float() @ router, w_up, w_down


def _moe_reference_f64(tokens, logits, w_up, w_down, k, cf):
    """The same routing with the experts in float64 on the card: the f32
    softmax and its top-k (the choices the port makes), the gates
    renormalised over the k and the k-major capacity, then every kept
    choice's expert output times its gate in float64; (out [T, D],
    dropped fraction)."""
    x = tokens.double()
    vals, idx = torch.topk(torch.softmax(logits.float(), -1), k, dim=-1)
    vals = vals.double()
    gates = vals / vals.sum(-1, keepdim=True)
    t, e = logits.shape
    cap = max(1, int(-(-(t * k * cf) // e)))
    flat = torch.nn.functional.one_hot(idx.t().reshape(-1), e)
    pos = ((flat.cumsum(0) - flat) * flat).sum(-1)
    kept = (pos < cap).reshape(k, t).t()
    out = torch.zeros_like(x)
    for ex in range(e):
        gate = (gates * ((idx == ex) & kept)).sum(-1)
        rows = (gate > 0).nonzero()[:, 0]
        if rows.numel():
            h = torch.nn.functional.silu(x[rows] @ w_up[ex].double())
            out[rows] += gate[rows, None] * (h @ w_down[ex].double())
    return out, 1.0 - kept.double().mean().item()


def phase_moe_dispatch(hvd, smi):
    """moe_dispatch: moe_dispatch_combine in a group of one (the NCCL
    world of one) at one bert-large MoE layer's shape, top_k 1 and 2,
    held against :func:`_moe_reference_f64`, with its time, dropped
    fraction and the bytes of each all-to-all; then the int8 ep wire
    (HVDT_TRANSPORT=ep:ring:int8:64M): #5 / #6 launches of a forward and
    backward, and its distance from the exact wire."""
    from horovod_tpu_torch.parallel import moe_capacity, moe_dispatch_combine
    from horovod_tpu_torch.parallel.moe import a2a_wire_bytes

    gen = torch.Generator(device="cuda").manual_seed(17)
    tokens, logits, w_up, w_down = _moe_layer(gen)

    def fn(x):
        return torch.bmm(torch.nn.functional.silu(torch.bmm(x, w_up)),
                         w_down)

    rows = {}
    for k in (1, 2):
        def call():
            return moe_dispatch_combine(tokens, logits, fn,
                                        experts_per_rank=MOE_E,
                                        capacity_factor=MOE_CF, top_k=k)

        out, aux = call()
        want, dropped = _moe_reference_f64(tokens, logits, w_up, w_down, k,
                                           MOE_CF)
        check = closeness(out.view(MOE_T, 1, 1, MOE_D),
                          want.view(MOE_T, 1, 1, MOE_D), MOE_ROW_TOL)
        assert check["err_over_tol"] <= 1, check
        assert abs(float(aux.dropped_fraction) - dropped) < 1e-6, (
            float(aux.dropped_fraction), dropped)
        cap = moe_capacity(MOE_T, MOE_E, top_k=k, capacity_factor=MOE_CF)
        slots = torch.randn((MOE_E, cap, MOE_D), generator=gen,
                            device="cuda").to(torch.bfloat16)
        rows[f"top_k{k}"] = {
            "ms": cuda_ms(call, iters=5, reps=3),
            # The split: the device alone (the calls queued behind a
            # ~50 ms device sleep), the host's enqueue, and the expert
            # products alone on the [E, cap, D] block.
            "device_ms": device_ms_stats(call, iters=3, reps=3,
                                         sleep_cycles=100_000_000),
            "enqueue_ms": enqueue_ms_stats(call, reps=5),
            "expert_products_ms": cuda_ms(lambda: fn(slots), iters=5,
                                          reps=3),
            "capacity": cap,
            "dropped_fraction": float(aux.dropped_fraction),
            "a2a_bytes_each": a2a_wire_bytes((1, MOE_E, cap, MOE_D),
                                             torch.bfloat16, None),
            "vs_float64": check}
    exact, _ = moe_dispatch_combine(tokens, logits, fn, experts_per_rank=MOE_E,
                                    capacity_factor=MOE_CF, top_k=2)
    os.environ["HVDT_TRANSPORT"] = "ep:ring:int8:64M"
    try:
        x = tokens.clone().requires_grad_()
        reset_counters()
        out, _ = moe_dispatch_combine(x, logits, fn, experts_per_rank=MOE_E,
                                      capacity_factor=MOE_CF, top_k=2)
        out.float().square().mean().backward()
        torch.cuda.synchronize()
        launches = counters()
    finally:
        del os.environ["HVDT_TRANSPORT"]
    int8_err = ((out.float() - exact.float()).norm()
                / exact.float().norm()).item()
    assert launches["_quant_kernel"] == launches["_dequant_kernel"] == 4, \
        launches
    assert int8_err <= 2e-2, int8_err
    cap2 = moe_capacity(MOE_T, MOE_E, top_k=2, capacity_factor=MOE_CF)
    emit({"phase": "moe_dispatch", "tokens": MOE_T, "d_model": MOE_D,
          "d_ff": MOE_F, "experts": MOE_E, "capacity_factor": MOE_CF,
          "dtype": "bfloat16", "router_logits": "float32", "rows": rows,
          "row_tolerance": MOE_ROW_TOL,
          "int8_wire": {"launches": {n: launches[n] for n in (
              "_quant_kernel", "_dequant_kernel")},
              "a2a_bytes_each": a2a_wire_bytes((1, MOE_E, cap2, MOE_D),
                                               torch.bfloat16, "int8"),
              "rel_l2_vs_exact_wire": int8_err, "tolerance": 2e-2},
          "card": smi})
    del tokens, logits, w_up, w_down, exact, out, x
    torch.cuda.empty_cache()


def phase_lm_moe(hvd, gen, smi):
    """lm_moe: the bert-large preset with num_experts=2 at ep=1 (the
    dense fallback), seq 512, batch 32, bf16, HVDT_FLASH_SMALLSEQ=on,
    fused Adam, 3 steps: losses finite and falling, tokens/s, #12 / #13
    / #1 launches, peak memory.  Returns the launches."""
    import dataclasses

    from horovod_tpu_torch.models import transformer_init

    for knob in ("HVDT_FLASH_ATTENTION", "HVDT_FLASH_SMALLSEQ_HB",
                 "HVDT_FLASH_BWD"):
        os.environ.pop(knob, None)
    os.environ["HVDT_FLASH_SMALLSEQ"] = "on"
    cfg = dataclasses.replace(lm_config(SS_SEQ), num_experts=2)
    model = transformer_init(0, cfg)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = hvd.DistributedOptimizer(
        hvd.fused_adam(model.parameters(), 3e-4, weight_decay=1e-4))
    tokens = torch.randint(0, cfg.vocab, (MOE_LM_BATCH, SS_SEQ),
                           generator=gen, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    times, losses = run_lm_steps(model, opt, tokens, cfg, 3)
    launches = counters()
    steady = sorted(times[1:])[len(times[1:]) // 2]
    emit({"phase": "lm_moe", "model": "bert-large", "num_experts": 2,
          "ep": 1, "batch": MOE_LM_BATCH, "seq": SS_SEQ,
          "params": sum(p.numel() for p in model.parameters()),
          "steps": 3, "losses": losses, "step_s": times,
          "steady_step_s": steady,
          "tokens_per_s": MOE_LM_BATCH * SS_SEQ / steady,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "launches": launches, "card": smi})
    assert all(math.isfinite(x) for x in losses), losses
    assert losses[-1] < losses[0], losses
    assert launches["_smallseq_fwd_kernel"] == 48 * 3, launches
    assert launches["_smallseq_bwd_kernel"] == 24 * 3, launches
    assert launches["_adam_kernel"] == 3, launches
    del model, opt, tokens
    gc.collect()
    torch.cuda.empty_cache()
    return launches


LM_TP1_BATCH = 32


def phase_lm_tp1(hvd, gen, smi):
    """lm_tp1: the bert-large preset at seq 512, batch 32, built through
    the sharding rules with tp and fsdp degree 1 (transformer_init with
    tp_rank / fsdp_rank, a mesh dp 1 x fsdp 1 x tp 1 whose groups go to
    the loss as tp_group / fsdp_group), HVDT_FLASH_SMALLSEQ=on: one step's
    loss and gradients against the dense model's (the same seed, no
    groups), in every byte; the parameters equal too; then the step
    under DistributedOptimizer(fused_adam, axis="dp").  Returns the
    launches of the grouped step."""
    import dataclasses

    from horovod_tpu_torch.common.basics import set_mesh
    from horovod_tpu_torch.models import transformer as tt
    from horovod_tpu_torch.parallel import make_mesh

    t0 = time.perf_counter()
    for knob in ("HVDT_FLASH_ATTENTION", "HVDT_FLASH_SMALLSEQ_HB",
                 "HVDT_FLASH_BWD"):
        os.environ.pop(knob, None)
    os.environ["HVDT_FLASH_SMALLSEQ"] = "on"
    cfg = lm_config(SS_SEQ)
    tokens = torch.randint(0, cfg.vocab, (LM_TP1_BATCH, SS_SEQ),
                           generator=gen, device="cuda")
    dense = tt.transformer_init(0, cfg)
    loss_d = tt.transformer_loss(dense, tokens, cfg)
    loss_d.backward()
    want = {n: p.grad for n, p in dense.named_parameters()}
    params_d = dict(dense.named_parameters())

    mesh = make_mesh(dp=1, fsdp=1, tp=1)
    rules_cfg = dataclasses.replace(cfg, tp=1, fsdp=1)
    model = tt.transformer_init(0, rules_cfg, tp_rank=0, fsdp_rank=0)
    same_params = all(torch.equal(p, params_d[n])
                      for n, p in model.named_parameters())
    opt = hvd.DistributedOptimizer(
        hvd.fused_adam(model.parameters(), 3e-4, weight_decay=1e-4),
        axis="dp")
    reset_counters()
    loss = tt.transformer_loss(model, tokens, rules_cfg, tp_group=mesh,
                               fsdp_group=mesh)
    loss.backward()
    grads_equal = {n: torch.equal(p.grad, want[n])
                   for n, p in model.named_parameters()}
    opt.step()
    torch.cuda.synchronize()
    launches = counters()
    set_mesh(None)
    emit({"phase": "lm_tp1", "model": "bert-large", "batch": LM_TP1_BATCH,
          "seq": SS_SEQ, "tp": 1, "fsdp": 1,
          "mesh": dict(zip(mesh.mesh_dim_names, list(mesh.mesh.shape))),
          "loss": loss.item(), "loss_dense": loss_d.item(),
          "params_equal": same_params,
          "grads_equal_in_every_byte": all(grads_equal.values()),
          "leaves": len(grads_equal), "launches": launches,
          "wall_s": time.perf_counter() - t0, "card": smi})
    assert same_params
    assert loss.item() == loss_d.item(), (loss.item(), loss_d.item())
    assert all(grads_equal.values()), grads_equal
    assert launches["_smallseq_fwd_kernel"] == 48, launches
    assert launches["_smallseq_bwd_kernel"] == 24, launches
    assert launches["_adam_kernel"] == 1, launches
    del dense, model, opt, want, params_d, tokens, loss, loss_d
    gc.collect()
    torch.cuda.empty_cache()
    return launches


class CountMm(TorchDispatchMode):
    """Counts the aten.mm it sees run (a product a selective checkpoint
    returns from its cache does not reach it)."""

    mm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.mm.default:
            self.mm += 1
        return func(*args, **(kwargs or {}))


def phase_lm_dots(hvd, gen, smi):
    """lm_dots: the bert-large preset (dense) at seq 512, batch 128,
    HVDT_FLASH_SMALLSEQ=on, remat_policy="dots" against "full": the
    gradients from one state (equal in every byte, or their distance),
    then 2 fused-Adam steps of each in turns (full, dots, dots, full)
    with step ms, peak memory and #12 launches; and at batch 4 the
    aten.mm the backward runs under none, full and dots (the recomputed
    ones: full's and dots' counts less none's)."""
    import dataclasses

    from horovod_tpu_torch.models import transformer_init, transformer_loss

    os.environ["HVDT_FLASH_SMALLSEQ"] = "on"
    cfgs = {"full": lm_config(SS_SEQ),
            "dots": dataclasses.replace(lm_config(SS_SEQ),
                                        remat_policy="dots")}
    model = transformer_init(0, cfgs["full"])
    opt = hvd.DistributedOptimizer(
        hvd.fused_adam(model.parameters(), 3e-4, weight_decay=1e-4))
    tokens = torch.randint(0, cfgs["full"].vocab, (SS_BATCH, SS_SEQ),
                           generator=gen, device="cuda")
    g_full = lm_grads(model, tokens, cfgs["full"])
    g_dots = lm_grads(model, tokens, cfgs["dots"])
    equal = all(torch.equal(g_full[n], g_dots[n]) for n in g_full)
    dist_l2 = max(((g_dots[n].float() - g_full[n].float()).norm()
                   / g_full[n].float().norm().clamp_min(1e-30)).item()
                  for n in g_full)
    del g_full, g_dots
    turns = []
    for policy in ("full", "dots", "dots", "full"):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counters()
        times, losses = run_lm_steps(model, opt, tokens, cfgs[policy], 2)
        launches = counters()
        assert all(math.isfinite(x) for x in losses), losses
        assert launches["_smallseq_fwd_kernel"] == 48 * 2, launches
        assert launches["_smallseq_bwd_kernel"] == 24 * 2, launches
        turns.append({"policy": policy, "step_s": times,
                      "losses": losses,
                      "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                      "smallseq_fwd_launches": launches[
                          "_smallseq_fwd_kernel"]})
    small = tokens[:DOTS_COUNT_BATCH]
    mm = {}
    for policy in ("none", "full", "dots"):
        cfg = dataclasses.replace(cfgs["full"], remat=policy != "none",
                                  remat_policy=("dots" if policy == "dots"
                                                else "full"))
        model.zero_grad(set_to_none=True)
        loss = transformer_loss(model, small, cfg)
        with CountMm() as count:
            loss.backward()
        mm[policy] = count.mm
    model.zero_grad(set_to_none=True)
    recomputed = {p: mm[p] - mm["none"] for p in ("full", "dots")}
    emit({"phase": "lm_dots", "model": "bert-large", "batch": SS_BATCH,
          "seq": SS_SEQ, "grads_equal_in_every_byte": equal,
          "grads_max_rel_l2_dots_vs_full": dist_l2, "turns": turns,
          "backward_mm": mm, "recomputed_mm": recomputed,
          "card": smi})
    assert recomputed["dots"] == 0 and recomputed["full"] > 0, mm
    assert dist_l2 <= 1e-2, dist_l2
    del model, opt, tokens
    gc.collect()
    torch.cuda.empty_cache()


def reset_counters():
    from horovod_tpu_torch.ops import conv_fused as cf
    from horovod_tpu_torch.ops import optim_kernels as ok
    from horovod_tpu_torch.ops import pallas_kernels as pk
    from horovod_tpu_torch.quant import kernels as qk

    pk._flash_fwd.launches = 0
    pk._flash_dq.launches = 0
    pk._flash_dkv.launches = 0
    pk._smallseq_fwd.launches = 0
    pk._smallseq_bwd.launches = 0
    cf._mm_forward.launches = 0
    cf.matmul_batch_stats.launches = 0
    ok._sgd_multi.launches = 0
    ok._adam_multi.launches = 0
    qk._quantize_cuda.launches = 0
    qk._dequantize_cuda.launches = 0
    qk._quantize4_cuda.launches = 0
    qk._dequantize4_cuda.launches = 0


def counters():
    from horovod_tpu_torch.ops import conv_fused as cf
    from horovod_tpu_torch.ops import optim_kernels as ok
    from horovod_tpu_torch.ops import pallas_kernels as pk
    from horovod_tpu_torch.quant import kernels as qk

    return {"_kernel": pk._flash_fwd.launches,
            "_dq_kernel": pk._flash_dq.launches,
            "_dkv_kernel": pk._flash_dkv.launches,
            "_smallseq_fwd_kernel": pk._smallseq_fwd.launches,
            "_smallseq_bwd_kernel": pk._smallseq_bwd.launches,
            "_mm_kernel": cf._mm_forward.launches,
            "_mm_stats_kernel": cf.matmul_batch_stats.launches,
            "_sgd_kernel": ok._sgd_multi.launches,
            "_adam_kernel": ok._adam_multi.launches,
            "_quant_kernel": qk._quantize_cuda.launches,
            "_dequant_kernel": qk._dequantize_cuda.launches,
            "_quant4_kernel": qk._quantize4_cuda.launches,
            "_dequant4_kernel": qk._dequantize4_cuda.launches}


def expected_quant_launches(hvd, model, steps, wire):
    """(quantize, dequantize) launches of ``steps`` steps of the
    error-feedback + quantized-wire path: per step, error feedback
    quantizes and dequantizes every gradient once; each float bucket is
    quantized twice (before the reduce-scatter, after the accumulate)
    and dequantized once after the gather, and once more before the
    accumulate on the int4 wire (the int8 accumulate is plain PyTorch,
    as it is XLA in the reference)."""
    grads = [p for p in model.parameters() if p.requires_grad]
    buckets = hvd.device.fused_allreduce_buckets(grads, None)
    deq = 2 if wire == "int4" else 1
    return (steps * (len(grads) + 2 * len(buckets)),
            steps * (len(grads) + deq * len(buckets)))


def quant_exchange_matches_plain(hvd, model, wire):
    """One fused_allreduce of the model's gradients over ``wire``, with
    the kernels and then with HVDT_QUANT_KERNELS=off: the same bytes."""
    grads = [p.grad.detach().clone() for p in model.parameters()]
    kern = hvd.device.fused_allreduce(grads, wire_dtype=wire)
    os.environ["HVDT_QUANT_KERNELS"] = "off"
    try:
        plain = hvd.device.fused_allreduce(grads, wire_dtype=wire)
    finally:
        del os.environ["HVDT_QUANT_KERNELS"]
    torch.cuda.synchronize()
    return max(_bit_err(a, b) for a, b in zip(kern, plain))


def run_steps(model, opt, images, labels, steps):
    from horovod_tpu_torch.models import resnet_loss

    times, losses = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt.zero_grad()
        loss, _ = resnet_loss(model, images, labels)
        loss.backward()
        opt.step()
        losses.append(loss.item())
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return times, losses


# ---- the eager phase: Horovod's named, negotiated collectives ---------------

EAGER_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.int32,
                torch.int64)
EAGER_OPS = ("AVERAGE", "SUM", "MIN", "MAX", "PRODUCT")
EAGER_SCALES = ((2.0, 1.0), (1.0, 0.5), (0.5, 3.0))
EAGER_STEPS = 3


def _eager_tensor(gen, dtype, shape, device="cuda"):
    if dtype.is_floating_point:
        return torch.randn(shape, generator=gen, device=device).to(dtype)
    return torch.randint(-50, 50, shape, generator=gen, device=device,
                         dtype=dtype)


def _times(x, factor):
    """``x`` times ``factor`` cast to x's dtype first: the scale of an
    eager allreduce (the reference's ``v * np.asarray(factor, v.dtype)``)."""
    return x * torch.tensor(factor, dtype=x.dtype) if factor != 1.0 else x


def _same_bits(name, got, want):
    """An eager result: a tensor on ``want``'s device, of its dtype and
    shape, holding its bytes."""
    assert isinstance(got, torch.Tensor), (name, type(got))
    assert got.device == want.device and got.dtype == want.dtype, \
        (name, got.device, got.dtype, want.device, want.dtype)
    err = _bit_err(got, want)
    assert err == 0.0, (name, err)


def _producer(gen, n=4096, chain=16):
    """A [n, n] f32 result of a chain of matmuls enqueued on the current
    stream: tens of ms of device work (TF32 off) still running when the
    eager call that reads it is made."""
    a = torch.randn((n, n), generator=gen, device="cuda") / math.sqrt(n)
    x = torch.randn((n, n), generator=gen, device="cuda")
    for _ in range(chain):
        x = x @ a
    return x


class _FusedResponses:
    """Records (tensors, bytes) of every response the eager controller
    executes while open."""

    def __enter__(self):
        from horovod_tpu_torch.common.types import torch_dtype_of
        from horovod_tpu_torch.ops import eager

        self.seen, self._cls = [], eager.EagerController
        orig = self._orig = eager.EagerController._dispatch
        seen = self.seen

        def spy(ctl, resp, entries):
            size = torch_dtype_of(resp.tensor_type).itemsize
            seen.append((len(resp.tensor_names),
                         sum(math.prod(s) for s in resp.tensor_shapes)
                         * size))
            return orig(ctl, resp, entries)

        self._cls._dispatch = spy
        return self

    def __exit__(self, *exc):
        self._cls._dispatch = self._orig


def _host_ms_of(fn, reps: int = 5) -> dict:
    """Host-clock time of ``fn`` (which returns once its work is done),
    from an idle device: median, min and max over ``reps``."""
    times = []
    for _ in range(reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return _stats(times[1:])


def eager_example_loop(hvd, gen, smi):
    """examples/jax_imagenet_resnet50.py's loop through the port's top
    level: broadcast_parameters, the start epoch by hvd.broadcast, then
    EAGER_STEPS steps of DistributedOptimizer(fused_sgd) with
    hvd.allreduce(loss, name="avg_loss") each step.  #4 must launch 26
    times a step and #2 once.  Returns the model's gradients."""
    from horovod_tpu_torch.models import ResNetConfig, resnet50_init, \
        resnet_loss

    cfg = ResNetConfig()
    model = resnet50_init(0, cfg)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    start_epoch = int(hvd.broadcast(
        torch.tensor(0, dtype=torch.int64, device="cuda"), root_rank=0,
        name="start_epoch"))
    assert start_epoch == 0
    opt = hvd.DistributedOptimizer(
        hvd.fused_sgd(model.parameters(), 0.01, momentum=0.9))
    images = torch.randn((BATCH, IMAGE, IMAGE, 3), generator=gen,
                         device="cuda")
    labels = torch.randint(0, cfg.num_classes, (BATCH,), generator=gen,
                           device="cuda")
    reset_counters()
    losses, avg, times = [], [], []
    for _ in range(EAGER_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt.zero_grad()
        loss, _ = resnet_loss(model, images, labels)
        loss.backward()
        opt.step()
        a = hvd.allreduce(loss.detach(), name="avg_loss")
        _same_bits("avg_loss", a, loss.detach())   # a world of one
        losses.append(loss.item())
        avg.append(a.item())
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = counters()
    assert all(math.isfinite(x) for x in losses), losses
    assert launches["_mm_stats_kernel"] == 26 * EAGER_STEPS, launches
    assert launches["_sgd_kernel"] == EAGER_STEPS, launches
    emit({"phase": "eager_train", "model": "resnet50", "batch": BATCH,
          "image": IMAGE, "steps": EAGER_STEPS, "losses": losses,
          "avg_loss": avg, "step_s": times, "launches": launches,
          "card": smi})
    grads = [p.grad.detach().clone() for p in model.parameters()]
    del model, opt, images, labels
    return grads


def eager_every_op(hvd, gen, smi):
    """Every eager op on CUDA tensors of each of EAGER_DTYPES, in the NCCL
    world of one: each result a tensor on the input's device and of its
    dtype, bit-identical to the world-of-one answer (the input, scaled
    where asked); then the producer-stream case and a numpy input."""
    count = 0
    for dt in EAGER_DTYPES:
        tag = str(dt).rsplit(".", 1)[-1]
        x = _eager_tensor(gen, dt, (64, 33))
        for op in EAGER_OPS:
            _same_bits(f"{tag}.{op}", hvd.allreduce(
                x, op=getattr(hvd.ReduceOp, op), name=f"e.{tag}.{op}"), x)
        for pre, post in EAGER_SCALES:
            _same_bits(f"{tag}.scale", hvd.allreduce(
                x, op=hvd.Sum, prescale_factor=pre, postscale_factor=post,
                name=f"e.{tag}.{pre}.{post}"), _times(_times(x, pre), post))
        parts = [x[:5], x[5:], x[:1]]
        for g, p in zip(hvd.grouped_allreduce(parts, op=hvd.Sum,
                                              name=f"e.{tag}.grp"), parts):
            _same_bits(f"{tag}.grouped", g, p)
        _same_bits(f"{tag}.allgather",
                   hvd.allgather(x[:7], name=f"e.{tag}.ag"), x[:7])
        _same_bits(f"{tag}.broadcast",
                   hvd.broadcast(x, 0, name=f"e.{tag}.bc"), x)
        out, splits = hvd.alltoall(x, splits=[64], name=f"e.{tag}.a2a")
        _same_bits(f"{tag}.alltoall", out, x)
        assert splits == [64], splits
        _same_bits(f"{tag}.reducescatter",
                   hvd.reducescatter(x, name=f"e.{tag}.rs"), x)
        count += len(EAGER_OPS) + len(EAGER_SCALES) + 5
    hvd.barrier()
    assert hvd.join() == 0
    obj = {"rank": 0, "card": smi}
    assert hvd.allgather_object(obj, name="e.obj") == [obj]
    # distinct indices: index_add_ on the card adds duplicates in any order
    idx = torch.randperm(100, generator=gen, device="cuda")[:17]
    vals = torch.randn((17, 8), generator=gen, device="cuda")
    sp = hvd.sparse_allreduce(idx, vals, (100, 8), name="e.sparse")
    _same_bits("sparse.indices", sp.indices, idx)
    _same_bits("sparse.values", sp.values, vals)
    _same_bits("sparse.dense", sp.to_dense(),
               torch.zeros((100, 8), device="cuda").index_add_(0, idx, vals))
    count += 5

    # The producer-stream case: the eager call reads a result that a side
    # stream is still computing; the controller's stream must wait for it.
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        x = _producer(gen)
        h = hvd.allreduce_async(x, name="e.producer")
        polled = hvd.poll(h)
        got = hvd.synchronize(h)
        want = x.clone()
    torch.cuda.synchronize()
    assert not polled, "poll was true before the producer finished"
    _same_bits("producer", got, want)
    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    out = hvd.allreduce(a, op=hvd.Max, name="e.numpy")
    assert isinstance(out, np.ndarray) and np.array_equal(out, a)
    count += 2
    emit({"phase": "eager_ops", "ops": count,
          "dtypes": [str(d).rsplit(".", 1)[-1] for d in EAGER_DTYPES],
          "bit_identical": True, "producer_polled_early": polled,
          "card": smi})
    return count


def eager_grouped_vs_fused(hvd, grads, name="e.grads"):
    """A grouped_allreduce of the model's gradient leaves through
    negotiation and fusion (HVDT_FUSION_THRESHOLD, 64 MiB by default):
    its fused responses and their bytes, the result against
    device.fused_allreduce of the same leaves, and the host ms of one call
    of each (the grouped call's enqueue alone beside it).  Returns (fused
    responses, largest difference, grouped ms, fused_allreduce ms)."""
    with _FusedResponses() as rec:
        got = hvd.grouped_allreduce(grads, name=name)
    want = hvd.device.fused_allreduce(grads)
    err = max(_bit_err(g, w) for g, w in zip(got, want))
    assert all(g.device == w.device and g.dtype == w.dtype
               for g, w in zip(got, want))
    enqueue = []

    def grouped():
        t0 = time.perf_counter()
        hs = hvd.grouped_allreduce_async(grads, name=name)
        enqueue.append((time.perf_counter() - t0) * 1e3)
        for h in hs:
            hvd.synchronize(h)

    grouped_ms = _host_ms_of(grouped)
    grouped_ms["enqueue_median"] = _stats(enqueue)["median"]
    fused_ms = _host_ms_of(lambda: hvd.device.fused_allreduce(grads))
    return rec.seen, err, grouped_ms, fused_ms


def eager_controller_costs(hvd, reps: int = 50):
    """Host ms from enqueue to synchronize of one small allreduce (a CUDA
    tensor and a numpy array), and the controller's negotiation cycles
    and control-plane round trips a second while idle."""
    from horovod_tpu_torch.ops import eager

    x = torch.ones(1024, device="cuda")
    a = np.ones(1024, np.float32)
    out = {}
    for kind, value in (("cuda", x), ("numpy", a)):
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            hvd.allreduce(value, name=f"e.latency.{kind}")
            times.append((time.perf_counter() - t0) * 1e3)
        out[f"enqueue_to_sync_ms_{kind}"] = _stats(times)
    ctl = eager._controller()
    trips = lambda: getattr(ctl.cp, "round_trips", 0)   # noqa: E731
    c0, rt0, t0 = ctl.cycles, trips(), time.perf_counter()
    time.sleep(1.0)
    dt = time.perf_counter() - t0
    out["idle_cycles_per_s"] = (ctl.cycles - c0) / dt
    out["idle_round_trips_per_s"] = (trips() - rt0) / dt
    out["control_plane"] = type(ctl.cp).__name__
    return out


def phase_eager(hvd, gen, smi):
    """The eager phase (see the module docstring)."""
    t0 = time.perf_counter()
    grads = eager_example_loop(hvd, gen, smi)
    assert len(grads) == 161 and sum(g.numel() for g in grads) > 25e6
    ops = eager_every_op(hvd, gen, smi)
    fused, err, grouped_ms, fused_ms = eager_grouped_vs_fused(hvd, grads)
    assert err == 0.0, err
    emit({"phase": "eager_grouped", "leaves": len(grads),
          "params": sum(g.numel() for g in grads),
          "bytes": sum(g.numel() * g.element_size() for g in grads),
          "threshold": hvd.ops.device._validated_threshold(None),
          "fused_responses": [{"tensors": t, "bytes": b} for t, b in fused],
          "max_abs_err_vs_fused_allreduce": err,
          "grouped_host_ms": grouped_ms, "fused_allreduce_host_ms": fused_ms,
          "card": smi})
    costs = eager_controller_costs(hvd)
    emit(dict(phase="eager_costs", card=smi, **costs))

    # A donated_step capture taken while eager ops are in flight (their
    # inputs still being produced) replays bit-identically to the eager
    # step, and the eager results hold.
    pending = []

    def in_flight(i):
        if i == 1:                      # the call that captures
            x = _producer(gen, chain=8)
            pending.append((x, [hvd.allreduce_async(x, name=f"e.cap.{k}")
                                for k in range(3)]))

    images = torch.randn((BATCH, IMAGE, IMAGE, 3), generator=gen,
                         device="cuda")
    labels = torch.randint(0, 1000, (BATCH,), generator=gen, device="cuda")
    cap_err, n = graphed_equals_eager(
        hvd, lambda ps: hvd.fused_sgd(ps, 0.01, momentum=0.9), images,
        labels, before_call=in_flight)
    assert cap_err == 0.0, cap_err
    (x, hs), = pending
    for h in hs:
        _same_bits("capture.in_flight", hvd.synchronize(h), x)
    emit({"phase": "eager_capture", "max_abs_err_graphed_vs_eager": cap_err,
          "tensors_compared": n, "eager_ops_in_flight": len(hs),
          "wall_s": time.perf_counter() - t0, "card": smi})
    del grads, images, labels, pending
    torch.cuda.empty_cache()
    return ops


# ---- python3 chip_smoke.py --ring-cards N: the ring across N cards ----------

RING_CARDS_TIMEOUT_S = 600
# The sp LM against the whole sequence on one card, hidden states after
# the final norm, relative L2 over the batch: the two attend the same keys
# through the same kernels in another order (ring_virtual: 0.04-0.26%
# relative L2 per attention output), and bf16 activations carry that
# through the layers: 0.7% after 2 layers and 1.4% after 24 in a CPU
# rehearsal (d 256, seq 512, 4 members, the kernels' plain versions),
# where positions left without their ring offset give 76%.  5e-2, as
# lm_default_phase's gradients.
RING_LM_HIDDEN_TOL = 5e-2


def _timed(fn, reps: int = 5, warmup: int = 2):
    """Median over ``reps`` of one call's time by CUDA events, every rank
    starting together (a barrier and a synchronize before each call)."""
    import torch.distributed as dist

    times = []
    for i in range(warmup + reps):
        dist.barrier()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        if i >= warmup:
            times.append(start.elapsed_time(end))
    return _stats(times)


def _gather_seq(t, n):
    """The members' shards of ``t`` ([B, l, ...]) joined along the
    sequence, on every rank."""
    import torch.distributed as dist

    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t.contiguous())
    return torch.cat(parts, 1)


def _gather_obj(obj, n):
    import torch.distributed as dist

    out = [None] * n
    dist.all_gather_object(out, obj)
    return out


def ring_cards_worker(device=None) -> None:
    """One rank of ``--ring-cards``: ring attention over NCCL between the
    cards (one rank a card, the mesh's sp dimension), held against
    whole-sequence flash_attention on rank 0; its forward and backward
    timed beside the same steps without transfers and beside a bare
    rotation; then the bert-large LM with sp = N at global seq N x
    RING_SHARD, batch RING_BATCH: hidden states against the whole
    sequence on one card, and 3 training steps (the ring's default on
    the card: kernels #9-#11).  Rank 0 prints the lines."""
    import dataclasses
    import importlib

    import torch.distributed as dist

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import transformer_hidden, transformer_init
    from horovod_tpu_torch.ops import pallas_kernels as pk
    from horovod_tpu_torch.parallel import make_mesh

    rmod = importlib.import_module(
        "horovod_tpu_torch.parallel.ring_attention")
    hvd.init(device=device)
    r, n = hvd.rank(), hvd.size()
    dev = hvd.topology().device
    lead = r == 0
    mesh = make_mesh(sp=n)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines() if dev.type == "cuda" \
        else ["cpu"]
    h, d, b, shard = LM_HEADS, LM_HEAD_DIM, RING_BATCH, RING_SHARD
    seq = n * shard
    rows = slice(r * shard, (r + 1) * shard)
    gen = torch.Generator(device=dev).manual_seed(0)
    c = _flash_case(pk, b, seq, seq, h, h, gen)
    glob = [c[x] for x in ("q", "k", "v", "do")]
    for t in glob:
        dist.broadcast(t, src=0)
    local = [x[:, rows].contiguous() for x in glob]

    # 1. The ring against the whole sequence, causal and not.
    checks = {}
    for causal in (True, False):
        reset_counters()
        got = _attn_grads(lambda q, k, v: rmod.ring_attention(
            q, k, v, group=mesh, causal=causal, use_pallas=True), *local)
        steps = r + 1 if causal else n
        launches = _gather_obj(_ring_launches(
            {"_kernel": steps, "_dq_kernel": steps, "_dkv_kernel": steps}),
            n)
        got = [_gather_seq(t, n) for t in got]
        if lead:
            want = _flash_kernel_bwd(pk, *glob, causal=causal)
            checks[f"causal_{causal}"] = {
                name: closeness(g, w, BF16_ULP) for name, g, w in
                zip(("out", "dq", "dk", "dv"), got, want)}
            checks[f"causal_{causal}_launches_by_rank"] = launches
            del want
        del got
    # The plain step (B 1) against the kernel step, on every rank.
    one = [x[:1] for x in local]
    plain = _attn_grads(lambda q, k, v: rmod.ring_attention(
        q, k, v, group=mesh, use_pallas=False), *one)
    kern = _attn_grads(lambda q, k, v: rmod.ring_attention(
        q, k, v, group=mesh, use_pallas=True), *one)
    errs = _gather_obj(max(closeness(g, w, 2 * BF16_ULP)["err_over_tol"]
                           for g, w in zip(plain, kern)), n)
    del plain, kern
    if lead:
        emit({"phase": "ring_cards", "members": n, "shard": shard,
              "global_seq": seq, "batch": b, "heads": h, "head_dim": d,
              "dtype": "bf16", "vs_whole_sequence": checks,
              "plain_vs_kernel_step_err_over_tol_by_rank": errs,
              "card": smi})
        assert all(o["err_over_tol"] <= 1.0 for key, v in checks.items()
                   if "launches" not in key for o in v.values()), checks
        assert max(errs) <= 1.0, errs

    # 2. Times: the ring (causal, kernels) against its steps without
    # transfers, and a bare rotation of one K/V block and of one dK/dV
    # accumulator.
    q, k, v = (x.detach().clone().requires_grad_() for x in local[:3])
    do = local[3]
    held = {}

    def fwd():
        held["out"] = rmod.ring_attention(q, k, v, group=mesh,
                                          use_pallas=True)

    def bwd():
        torch.autograd.grad(held["out"], (q, k, v), do, retain_graph=True)

    shards = [[x[:, i * shard:(i + 1) * shard].contiguous()
               for i in range(n)] for x in glob[:3]]
    kw = dict(causal=True, scale=d ** -0.5, use_pallas=True)

    def compute_fwd():
        carry = rmod._init_carry(local[0])
        for s_ in range(n):
            src = (r - s_) % n
            carry = rmod._forward_step(local[0], shards[1][src],
                                       shards[2][src], carry, src=src,
                                       my=r, **kw)
        held["fin"] = rmod._finish(carry, local[0].dtype)

    def compute_bwd():
        inp = rmod._bwd_inputs(local[0], do, *held["fin"], True)
        for s_ in range(n):
            src = (r - s_) % n
            rmod._backward_step(inp, shards[1][src], shards[2][src],
                                src=src, my=r, **kw)

    peer = rmod._Ring(mesh)
    acc = [torch.zeros(local[1].shape, dtype=torch.float32, device=dev)
           for _ in range(2)]

    def rotate(*ts):
        _, p = peer.post(*ts)
        p.wait()

    times = {"ring_fwd": _timed(fwd), "ring_bwd": _timed(bwd),
             "steps_fwd": _timed(compute_fwd),
             "steps_bwd": _timed(compute_bwd),
             "rotate_kv": _timed(lambda: rotate(local[1], local[2])),
             "rotate_dkv": _timed(lambda: rotate(*acc))}
    del held["out"]
    by_rank = _gather_obj({k_: t["median"] for k_, t in times.items()}, n)
    kv_bytes = 2 * local[1].numel() * local[1].element_size()
    if lead:
        emit({"phase": "ring_cards_time", "members": n, "causal": True,
              "shape": [b, shard, h, h, d], "ms_by_rank": by_rank,
              "kv_block_bytes": kv_bytes,
              "rotate_kv_gb_per_s_by_rank": [
                  kv_bytes / (x["rotate_kv"] * 1e-3) / 1e9 for x in by_rank],
              "note": "ring_* are the entry point (transfers posted before "
                      "each step); steps_* the same kernel steps without "
                      "transfers; rotate_* one bare send/receive pair",
              "card": smi})
    del q, k, v, do, shards, acc, c, glob, local
    torch.cuda.empty_cache()

    # 3. The sp LM: bert-large at global seq N x RING_SHARD.
    cfg = dataclasses.replace(lm_config(seq), sp=n)
    model = transformer_init(0, cfg, device=dev)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    tokens = torch.randint(0, cfg.vocab, (b, seq), generator=gen,
                           device=dev)
    dist.broadcast(tokens, src=0)
    mine = tokens[:, rows].contiguous()
    with torch.no_grad():
        hid = _gather_seq(transformer_hidden(model, mine, cfg,
                                             sp_group=mesh), n)
        if lead:
            whole = transformer_hidden(model, tokens,
                                       dataclasses.replace(cfg, sp=1))
            hid_err = ((hid.float() - whole.float()).norm()
                       / whole.float().norm()).item()
            del whole
    del hid
    opt = hvd.DistributedOptimizer(
        hvd.fused_adam(model.parameters(), 3e-4, weight_decay=1e-4))
    steps, per = 3, r + 1
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    t, losses = run_lm_steps(model, opt, mine, cfg, steps, sp_group=mesh)
    launches = counters()
    assert launches["_kernel"] == 2 * cfg.layers * per * steps, launches
    assert launches["_dq_kernel"] == cfg.layers * per * steps, launches
    assert launches["_dkv_kernel"] == cfg.layers * per * steps, launches
    assert launches["_adam_kernel"] == steps, launches
    assert all(math.isfinite(x) for x in losses), losses
    runs = {"kernel": {"step_s": t, "losses": losses,
                       "peak_mem_gb": torch.cuda.max_memory_allocated()
                       / 1e9}}
    every = _gather_obj(runs, n)
    if lead:
        out = {}
        for name in runs:
            steady = [sorted(x[name]["step_s"][1:])[
                len(x[name]["step_s"][1:]) // 2] for x in every]
            out[name] = {
                "step_s_by_rank": [x[name]["step_s"] for x in every],
                "ring_mean_loss": [sum(x[name]["losses"][i] for x in every)
                                   / n for i in range(len(runs[name]
                                                         ["losses"]))],
                "steady_step_s": max(steady),
                "tokens_per_s": b * seq / max(steady),
                "peak_mem_gb_by_rank": [x[name]["peak_mem_gb"]
                                        for x in every]}
        emit({"phase": "ring_cards_lm", "model": "bert-large",
              "layers": cfg.layers, "sp": n, "global_seq": seq, "batch": b,
              "hidden_rel_l2_vs_whole_sequence": hid_err,
              "hidden_tolerance": RING_LM_HIDDEN_TOL, **out, "card": smi})
        assert hid_err <= RING_LM_HIDDEN_TOL, hid_err
    del model, opt
    gc.collect()
    torch.cuda.empty_cache()

    # 4. The same sp LM step under donated_step against it eagerly.
    def make():
        m = transformer_init(0, cfg, device=dev)
        return m, hvd.DistributedOptimizer(
            hvd.fused_adam(m.parameters(), 3e-4, weight_decay=1e-4))

    graphed_lm("ring_cards_graphed", cfg, make, mine, {"sp_group": mesh},
               smi, sp=n, global_seq=seq, batch=b)
    dist.barrier()
    hvd.shutdown()


# ---- the ring and the pipeline inside a donated_step capture ---------------

GRAPHED_CALLS = 3        # eager warm-up, capture + replay, replay
GRAPHED_TIMED = 3        # calls a turn of the graphed / eager timing
# Graphed against eager: the same kernels and NCCL operations in the same
# order on the same inputs, so equal bytes (relative errors of 0).
GRAPHED_LM_TOL = 0.0
# Kernel names in a torch.profiler trace, by kernel of the LM's path
# (#13 is two CUDA kernels a call, dQ then dK/dV).
LM_REPLAY_KERNELS = (("_kernel", "flash_fwd_kernel"),
                     ("_dq_kernel", "flash_dq_kernel"),
                     ("_dkv_kernel", "flash_dkv_kernel"),
                     ("_smallseq_fwd_kernel", "smallseq_fwd_kernel"),
                     ("_smallseq_dq", "smallseq_dq_kernel"),
                     ("_smallseq_dkv", "smallseq_dkv_kernel"),
                     ("_adam_kernel", "optim_multi<true>"),
                     ("nccl", "nccl"))


def _lm_step_fn(cfg, groups):
    """One LM train step ``(model, opt, tokens) -> loss`` over the
    parallel ``groups`` (the loss's ``sp_group`` / ``pp_group`` / ...)."""
    from horovod_tpu_torch.models import transformer_loss

    def step(model, opt, tokens):
        opt.zero_grad(set_to_none=True)
        loss = transformer_loss(model, tokens, cfg, **groups)
        loss.backward()
        opt.step()
        return loss.detach()

    return step


def _replay_want(first: dict) -> dict:
    """A replay's kernels by :data:`LM_REPLAY_KERNELS`, from the launch
    counters of one eager step."""
    return {"_kernel": first["_kernel"], "_dq_kernel": first["_dq_kernel"],
            "_dkv_kernel": first["_dkv_kernel"],
            "_smallseq_fwd_kernel": first["_smallseq_fwd_kernel"],
            "_smallseq_dq": first["_smallseq_bwd_kernel"],
            "_smallseq_dkv": first["_smallseq_bwd_kernel"],
            "_adam_kernel": first["_adam_kernel"]}


def _rel_err(got, want) -> float:
    """Relative L2 distance of two tensors (0 where both are 0)."""
    d = (got.double() - want.double()).norm()
    return (d / want.double().norm().clamp_min(1e-30)).item()


def graphed_lm(name, cfg, make, tokens, groups, smi, **row):
    """The LM step under ``step_pipeline.donated_step`` against the same
    step eagerly, every rank of the world taking part.  ``make()`` gives
    a fresh (model, optimizer) from the same seed; each leg runs
    :data:`GRAPHED_CALLS` calls (graphed: the eager warm-up, the capture
    and its replay, a replay).  Held: every call's loss, each rank's
    gradients after the last call and its parameters, against the eager
    leg's within :data:`GRAPHED_LM_TOL`; one replay's kernels
    (torch.profiler) against one eager step's launch counters.  Then
    the step's seconds graphed and eager in turns (eager, graphed,
    graphed, eager; :data:`GRAPHED_TIMED` calls a turn, the slowest
    rank's), and each leg's peak memory above what was allocated at its
    start.  Rank 0 prints the line."""
    import torch.distributed as dist

    from horovod_tpu_torch.step_pipeline import donated_step

    r, n = dist.get_rank(), dist.get_world_size()
    t0 = time.perf_counter()
    step = _lm_step_fn(cfg, groups)
    legs = {}
    for leg in ("eager", "graphed"):
        model, opt = make()
        fn = donated_step(step) if leg == "graphed" else step
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_counters()
        losses, first = [], None
        for _ in range(GRAPHED_CALLS):
            losses.append(fn(model, opt, tokens).float().clone())
            if first is None:
                first = counters()
        torch.cuda.synchronize()
        legs[leg] = {"model": model, "opt": opt, "fn": fn, "first": first,
                     "losses": [x.item() for x in losses],
                     "peak_gb": (torch.cuda.max_memory_allocated() - base)
                     / 1e9}
    e, g = legs["eager"], legs["graphed"]
    pairs = list(zip(e["model"].parameters(), g["model"].parameters()))
    errs = torch.tensor([
        max(abs(a - b) / abs(a) for a, b in zip(e["losses"], g["losses"])),
        max(_rel_err(pg.grad, pe.grad) for pe, pg in pairs),
        max(_rel_err(pg, pe) for pe, pg in pairs),
        float(not all(torch.equal(pe.grad, pg.grad) and torch.equal(pe, pg)
                      for pe, pg in pairs))], device="cuda")
    dist.all_reduce(errs, op=dist.ReduceOp.MAX)
    loss_err, grad_err, param_err, unequal = errs.tolist()
    replay = replay_kernels(lambda: g["fn"](g["model"], g["opt"], tokens),
                            LM_REPLAY_KERNELS)
    want = _replay_want(e["first"])
    replay_ok = all(replay[k] == v for k, v in want.items())

    def turn(leg):
        dist.barrier()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(GRAPHED_TIMED):
            leg["fn"](leg["model"], leg["opt"], tokens)
        torch.cuda.synchronize()
        return (time.perf_counter() - t1) / GRAPHED_TIMED

    order = ("eager", "graphed", "graphed", "eager")
    times = torch.tensor([turn(legs[leg]) for leg in order], device="cuda")
    dist.all_reduce(times, op=dist.ReduceOp.MAX)
    step_s = {leg: [t for o, t in zip(order, times.tolist()) if o == leg]
              for leg in ("eager", "graphed")}
    peaks = _gather_obj({leg: legs[leg]["peak_gb"] for leg in legs}, n)
    every = _gather_obj({"replay": replay, "want": want,
                         "eager_step_launches": e["first"]}, n)
    if r == 0:
        emit({"phase": name, "cards": n, "model": "bert-large",
              "layers": cfg.layers, **row, "calls": GRAPHED_CALLS,
              "losses_eager_rank0": e["losses"],
              "losses_graphed_rank0": g["losses"],
              "equal_bytes": not unequal, "loss_rel_err": loss_err,
              "grad_rel_l2_max": grad_err, "param_rel_l2_max": param_err,
              "tolerance": GRAPHED_LM_TOL,
              "step_s_in_turns": {"order": list(order), **step_s},
              "graphed_speedup": (sum(step_s["eager"])
                                  / sum(step_s["graphed"])),
              "peak_mem_gb_above_start_by_rank": peaks,
              "replay_kernels_by_rank": [x["replay"] for x in every],
              "eager_step_kernels_by_rank": [x["want"] for x in every],
              "wall_s": time.perf_counter() - t0, "card": smi})
    assert max(loss_err, grad_err, param_err) <= GRAPHED_LM_TOL, (
        name, loss_err, grad_err, param_err)
    assert replay_ok, (name, replay, want)
    del legs, e, g, pairs
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()


def _spawn_ranks(n: int, flag: str, timeout_s: float) -> int:
    """Run this script with ``flag`` as N processes, one a card, in an
    NCCL world (``HVDT_SIZE/RANK/LOCAL_RANK/COORDINATOR_ADDR``); 0 when
    every rank exits 0.  A rank that fails, or the timeout, stops them
    all."""
    import socket

    here = os.path.dirname(os.path.abspath(__file__))
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, HVDT_SIZE=str(n), HVDT_LOCAL_SIZE=str(n),
               HVDT_COORDINATOR_ADDR=f"127.0.0.1:{port}",
               PYTHONPATH=here + os.pathsep + os.environ.get("PYTHONPATH",
                                                            ""))
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), flag],
        env=dict(env, HVDT_RANK=str(r), HVDT_LOCAL_RANK=str(r)))
        for r in range(n)]
    deadline = time.time() + timeout_s
    try:
        while any(p.poll() is None for p in procs):
            failed = [p.returncode for p in procs if p.poll()]
            if failed or time.time() > deadline:
                print(f"chip_smoke: {flag} rank failed ({failed}) or timed "
                      "out", file=sys.stderr)
                return 1
            time.sleep(1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return 1 if any(p.returncode for p in procs) else 0


def _last_lines(smi: str) -> None:
    """The card's name and power limit, then the contract's last line."""
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


def ring_cards(n: int) -> int:
    """``python3 chip_smoke.py --ring-cards N``: build the kernels, then
    run :func:`ring_cards_worker` as N processes, one a card, in an NCCL
    world (rank 0 prints the lines).  A rank that fails stops them all."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        print(f"chip_smoke: --ring-cards {n} needs {n} CUDA cards",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import horovod_tpu_torch  # noqa: F401  (fails outside the repo)

    t0 = time.perf_counter()
    smi = phase_device()
    phase_build()
    rc = _spawn_ranks(n, "--ring-worker", RING_CARDS_TIMEOUT_S)
    if rc:
        return rc
    emit({"phase": "ring_cards_total", "wall_s": time.perf_counter() - t0})
    _last_lines(smi)
    return 0

# ---- python3 chip_smoke.py --eager-cards N: the eager core across N cards ---

EAGER_CARDS_TIMEOUT_S = 600


def _rank_input(q, dtype, shape, seed):
    """Rank ``q``'s seeded input (on the host, so that every rank can make
    every rank's and compute the answer)."""
    g = torch.Generator().manual_seed(1000 * seed + q)
    if dtype == torch.int64:
        return torch.randint(-2**40, 2**40, shape, generator=g,
                             dtype=dtype)
    if not dtype.is_floating_point:
        return torch.randint(-9, 10, shape, generator=g, dtype=dtype)
    return torch.randn(shape, generator=g).to(dtype)


def _np(x):
    """A tensor as numpy (floats as float64: numpy has no bfloat16)."""
    x = x.detach().cpu()
    return x.double().numpy() if x.is_floating_point() else x.numpy()


def _np_answer(op, xs):
    """numpy's answer for the reduction ``op`` over the ranks' inputs (in
    float64 for floats; integer Average truncates toward zero)."""
    a = np.stack([_np(x) for x in xs])
    if op == "SUM":
        return a.sum(0)
    if op == "AVERAGE":
        s = a.sum(0)
        return s / len(xs) if a.dtype.kind == "f" else np.trunc(
            s / len(xs)).astype(a.dtype)
    if op == "PRODUCT":
        return a.prod(0)
    return a.min(0) if op == "MIN" else a.max(0)


def _held(name, got, want, dtype, summands=None):
    """Exact for integers and for MIN/MAX/moves (``summands`` None); for
    a float sum, within the dtype's rounding of the summands' magnitude."""
    got = _np(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    if summands is None or not dtype.is_floating_point:
        if dtype.is_floating_point:
            want = torch.from_numpy(want).to(dtype).double().numpy()
        assert np.array_equal(got, want), (name, np.abs(got - want).max())
        return 0.0
    eps = {torch.float32: 2**-23, torch.bfloat16: 2**-7,
           torch.float16: 2**-10}[dtype]
    scale = np.abs(np.stack([_np(s) for s in summands])).sum(0)
    err = np.abs(got - want)
    assert (err <= 4 * eps * (scale + np.abs(want)) + 1e-30).all(), \
        (name, err.max())
    return float(err.max())


def eager_cards_worker(device=None) -> None:
    """One rank of ``--eager-cards``: every eager op across the cards,
    issued in a different order on each rank and held against numpy's
    answer; a joined rank; one named uneven alltoall called three times;
    the 161-leaf grouped allreduce of ResNet-50's
    gradient shapes against device.fused_allreduce; one small allreduce's
    host latency and the control plane's store round trips a cycle.
    Rank 0 prints the lines."""
    import torch.distributed as dist

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import ResNetConfig, resnet50_init
    from horovod_tpu_torch.ops import eager

    hvd.init(device=device)
    r, n = hvd.rank(), hvd.size()
    dev = hvd.topology().device
    lead = r == 0
    t_start = time.perf_counter()

    def on_dev(x):
        return x.to(dev)

    # Every op, every dtype, a different issue order on each rank.
    specs = []   # (fn, name, per-rank inputs, kwargs, check)
    for k, dt in enumerate(EAGER_DTYPES):
        tag = str(dt).rsplit(".", 1)[-1]
        for op in EAGER_OPS:
            if op == "PRODUCT" and dt in (torch.bfloat16, torch.float16,
                                          torch.int64):
                continue
            xs = [_rank_input(q, dt, (33, 5), 10 * k + len(specs))
                  for q in range(n)]
            specs.append(("allreduce", f"c.{tag}.{op}", xs,
                          {"op": getattr(hvd.ReduceOp, op)},
                          ("reduce", op)))
        xs = [_rank_input(q, dt, (q + 1, 3), 500 + k) for q in range(n)]
        specs.append(("allgather", f"c.{tag}.ag", xs, {}, ("gather",)))
        xs = [_rank_input(q, dt, (6,), 600 + k) for q in range(n)]
        specs.append(("broadcast", f"c.{tag}.bc", xs,
                      {"root_rank": n - 1}, ("bcast", n - 1)))
        splits = [[(q + j) % 3 for j in range(n)] for q in range(n)]
        xs = [_rank_input(q, dt, (sum(splits[q]), 2), 700 + k)
              for q in range(n)]
        specs.append(("alltoall", f"c.{tag}.a2a", xs,
                      {"splits": splits[r]}, ("a2a", splits)))
        xs = [_rank_input(q, dt, (2 * n + 1, 4), 800 + k) for q in range(n)]
        specs.append(("reducescatter", f"c.{tag}.rs", xs, {"op": hvd.Sum},
                      ("rs",)))
    xs = [_rank_input(q, torch.float32, (8,), 900) for q in range(n)]
    specs.append(("allreduce", "c.scaled", xs,
                  {"op": hvd.Sum, "prescale_factor": 0.5,
                   "postscale_factor": 3.0}, ("scaled",)))
    order = torch.randperm(len(specs),
                           generator=torch.Generator().manual_seed(r))
    dist.barrier()
    handles = {}
    for i in order.tolist():
        fn, name, xs, kw, _ = specs[i]
        handles[name] = getattr(hvd, fn + "_async")(on_dev(xs[r]), name=name,
                                                    **kw)
    max_err = 0.0
    for fn, name, xs, kw, check in specs:
        got = hvd.synchronize(handles[name])
        dt = xs[0].dtype
        if check[0] == "reduce":
            # a float product rounds at each factor: relative to itself
            rounded = {"SUM": xs, "AVERAGE": xs,
                       "PRODUCT": [torch.zeros_like(xs[0])]}.get(check[1])
            max_err = max(max_err, _held(name, got, _np_answer(check[1], xs),
                                         dt, rounded))
        elif check[0] == "scaled":
            scaled = [x * torch.tensor(0.5) for x in xs]
            max_err = max(max_err, _held(
                name, got, _np_answer("SUM", scaled) * 3.0, dt,
                [3 * x for x in scaled]))
        elif check[0] == "gather":
            _held(name, got, _np(torch.cat(xs)), dt)
        elif check[0] == "bcast":
            _held(name, got, _np(xs[check[1]]), dt)
        elif check[0] == "a2a":
            out, recv = got
            sp = check[1]
            parts = [xs[q][sum(sp[q][:r]):sum(sp[q][:r + 1])]
                     for q in range(n)]
            assert recv == [sp[q][r] for q in range(n)], (name, recv)
            _held(name, out, _np(torch.cat(parts)), dt)
        else:
            full = _np_answer("SUM", xs)
            base, rem = divmod(full.shape[0], n)
            start = r * base + min(r, rem)
            stop = start + base + (r < rem)
            max_err = max(max_err, _held(
                name, got, full[start:stop], dt,
                [x[start:stop] for x in xs]))
        if isinstance(got, tuple):
            got = got[0]
        assert got.device == dev and got.dtype == dt, (name, got.device)

    # A joined rank: the last rank joins at once, the others reduce twice.
    if r != n - 1:
        s = hvd.allreduce(torch.full((3,), float(r + 1), device=dev),
                          name="c.join.sum", op=hvd.Sum)
        m = hvd.allreduce(torch.full((3,), r + 5, device=dev,
                                     dtype=torch.int32),
                          name="c.join.min", op=hvd.Min)
        assert s.tolist() == [float(sum(q + 1 for q in range(n - 1)))] * 3
        assert m.tolist() == [5] * 3      # the joined rank adds MIN's identity
    last = hvd.join()
    assert 0 <= last < max(n - 1, 1), last
    objs = hvd.allgather_object({"rank": r}, name="c.obj")
    assert objs == [{"rank": q} for q in range(n)], objs
    # One named alltoall three times, each rank with its own send splits
    # and the same shape every call: each call must send with them.
    base = [j + 1 for j in range(n)]
    rot = [base[q:] + base[:q] for q in range(n)]
    for step in range(3):
        xs = [_rank_input(q, torch.float32, (sum(base), 2), 950 + step)
              for q in range(n)]
        out, recv = hvd.alltoall(on_dev(xs[r]), splits=rot[r],
                                 name="c.a2a.repeat")
        assert recv == [rot[q][r] for q in range(n)], (step, recv)
        _held("c.a2a.repeat", out, _np(torch.cat(
            [xs[q][sum(rot[q][:r]):sum(rot[q][:r + 1])] for q in range(n)])),
            torch.float32)
    if lead:
        emit({"phase": "eager_cards", "cards": n, "ops": len(specs),
              "a2a_repeats": 3, "max_abs_err_float_sums": max_err,
              "last_joined": last, "wall_s": time.perf_counter() - t_start})

    # Adasum through the eager core: each rank's seeded vector against the
    # host tree over every rank's vector (float64, then one rounding to
    # the dtype: 1e-6 of the largest magnitude for f32, a bf16 ulp of
    # each element for bf16).
    from horovod_tpu_torch.ops.adasum import _np_adasum_tree

    ada = {}
    for dtype, rel, floor in ((torch.float32, 0.0, 1e-6),
                              (torch.bfloat16, 2.0 ** -7, 1e-6)):
        xs = [_rank_input(q, dtype, (4099,), 970) for q in range(n)]
        got = _np(hvd.allreduce(on_dev(xs[r]), op=hvd.Adasum,
                                name=f"c.adasum.{dtype}"))
        want = _np_adasum_tree([_np(x) for x in xs])
        err = np.abs(got - want)
        assert (err <= rel * np.abs(want) + floor * np.abs(want).max()
                ).all(), (dtype, err.max())
        ada[str(dtype).split(".")[-1]] = float(err.max())
    if lead:
        emit({"phase": "eager_cards_adasum", "cards": n, "elements": 4099,
              "max_abs_err_vs_host_tree": ada})

    # The 161 gradient leaves of ResNet-50, seeded per rank.
    model = resnet50_init(0, ResNetConfig(), device=dev)
    g = torch.Generator(device=dev).manual_seed(r)
    grads = [torch.randn(p.shape, generator=g, device=dev)
             for p in model.parameters()]
    del model
    fused, err, grouped_ms, fused_ms = eager_grouped_vs_fused(
        hvd, grads, name="c.grads")
    # The ranks' sums in the order of each plan's buckets: NCCL may add
    # them in another order for another bucket boundary.
    assert err <= 1e-5, err
    ctl = eager._controller()
    lat = []
    for _ in range(50):
        dist.barrier()
        t0 = time.perf_counter()
        hvd.allreduce(torch.ones(1024, device=dev), name="c.latency")
        lat.append((time.perf_counter() - t0) * 1e3)
    c0, rt0, t0 = ctl.cycles, ctl.cp.round_trips, time.perf_counter()
    time.sleep(1.0)
    cycles = ctl.cycles - c0
    stats = {"idle_cycles_per_s": cycles / (time.perf_counter() - t0),
             "round_trips_per_cycle": (ctl.cp.round_trips - rt0)
             / max(cycles, 1)}
    every = [None] * n
    dist.all_gather_object(every, stats)
    if lead:
        emit({"phase": "eager_cards_grouped", "cards": n,
              "leaves": len(grads),
              "bytes": sum(x.numel() * x.element_size() for x in grads),
              "fused_responses": [{"tensors": t, "bytes": b}
                                  for t, b in fused],
              "max_abs_err_vs_fused_allreduce": err,
              "grouped_host_ms": grouped_ms,
              "fused_allreduce_host_ms": fused_ms,
              "enqueue_to_sync_ms": _stats(lat), "control_plane": every})
    hvd.shutdown()


def eager_cards(n: int) -> int:
    """``python3 chip_smoke.py --eager-cards N``: run
    :func:`eager_cards_worker` as N processes, one a card, in an NCCL
    world (rank 0 prints the lines).  A rank that fails stops them all.
    No kernel is built: this mode runs no kernel."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        print(f"chip_smoke: --eager-cards {n} needs {n} CUDA cards",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import horovod_tpu_torch  # noqa: F401  (fails outside the repo)

    t0 = time.perf_counter()
    smi = phase_device()
    rc = _spawn_ranks(n, "--eager-worker", EAGER_CARDS_TIMEOUT_S)
    if rc:
        return rc
    rc = eager_desync(n)
    if rc:
        return rc
    emit({"phase": "eager_cards_total", "wall_s": time.perf_counter() - t0})
    _last_lines(smi)
    return 0


# The desync case: stall knobs short enough for a run, and the bound on the
# seconds from the skipped collective's enqueue to each rank's report.
EAGER_DESYNC_ABORT_S = 3
EAGER_DESYNC_BOUND_S = 15.0
EAGER_DESYNC_TIMEOUT_S = 180


def eager_desync(n: int) -> int:
    """The desync case of ``--eager-cards``: N fresh ranks, one a card,
    with the flight recorder and the telemetry exporter on
    (HVDT_TELEMETRY_PUBLISH_S=0.5 over a rendezvous KV this process
    serves) and HVDT_STALL_ABORT_TIME_SECONDS=EAGER_DESYNC_ABORT_S; the
    last rank skips the named allreduce ``d.skipped``
    (:func:`eager_desync_worker`)."""
    import tempfile

    from horovod_tpu_torch.runner.http_kv import RendezvousServer

    server = RendezvousServer(addr="127.0.0.1")
    server.start()
    trace_dir = tempfile.mkdtemp(prefix="chip_smoke_desync_")
    knobs = {"HVDT_FLIGHT_RECORDER": "1", "HVDT_TELEMETRY": "1",
             "HVDT_TELEMETRY_PUBLISH_S": "0.5", "HVDT_METRICS_PORT": "0",
             "HVDT_TRACE_DIR": trace_dir,
             "HVDT_STALL_CHECK_TIME_SECONDS": "1",
             "HVDT_STALL_ABORT_TIME_SECONDS": str(EAGER_DESYNC_ABORT_S),
             "HVDT_RENDEZVOUS_ADDR": "127.0.0.1",
             "HVDT_RENDEZVOUS_PORT": str(server.port),
             "HVDT_SECRET": server.secret.hex()}
    saved = {k: os.environ.get(k) for k in knobs}
    os.environ.update(knobs)
    try:
        return _spawn_ranks(n, "--eager-desync-worker",
                            EAGER_DESYNC_TIMEOUT_S)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        server.stop()
        shutil.rmtree(trace_dir, ignore_errors=True)


def eager_desync_worker() -> int:
    """One rank of the desync case: three named allreduces on every rank,
    then ``d.skipped`` on every rank but the last, which sleeps past the
    abort.  The coordinator's abort rung writes its desync report
    (HVDT_TRACE_DIR/desync_report_rank0.json); then every rank publishes
    its flight recorder, and after a barrier each one emits the report
    over the KV.  Every report must name the same first divergent
    collective (seq and name, the last rank missing), and each rank's
    within EAGER_DESYNC_BOUND_S of its enqueue.  Rank 0 prints the
    line."""
    import torch.distributed as dist

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.runner.http_kv import KVClient
    from horovod_tpu_torch.telemetry import flight_recorder as fr

    try:
        hvd.init()
        r, n = hvd.rank(), hvd.size()
        dev = hvd.topology().device
        skipper = n - 1
        dist.barrier()
        for k in range(3):
            hvd.allreduce(torch.ones(1024, device=dev), name=f"d.grad.{k}")
        t0 = time.perf_counter()
        if r != skipper:
            try:
                hvd.allreduce(torch.ones(1024, device=dev), name="d.skipped")
                outcome = "completed"
            except hvd.HorovodInternalError as e:
                outcome = str(e)
        else:
            time.sleep(EAGER_DESYNC_ABORT_S + 2.0)
            outcome = "never issued"
        abort_s = time.perf_counter() - t0
        rec = fr.get_flight_recorder()
        kv = KVClient.from_env()
        rec.publish(kv)
        dist.barrier()
        report = fr.emit_desync_report(
            stalled="d.skipped", kv_client=kv, size=n,
            out_dir=os.path.join(os.environ["HVDT_TRACE_DIR"], "ranks"))
        report_s = time.perf_counter() - t0
        head = {"rank": r, "outcome": outcome, "abort_s": abort_s,
                "report_s": report_s,
                "first_divergent_seq": report["first_divergent_seq"],
                "name": report["divergent_event"]["name"],
                "missing_ranks": report["missing_ranks"],
                "mismatches": len(report["mismatches"])}
        heads = [None] * n
        dist.all_gather_object(heads, head)
        if r == 0:
            with open(os.path.join(os.environ["HVDT_TRACE_DIR"],
                                   "desync_report_rank0.json")) as f:
                auto = json.load(f)
            first = {(h["first_divergent_seq"], h["name"],
                      tuple(h["missing_ranks"])) for h in heads}
            first.add((auto["first_divergent_seq"],
                       auto["divergent_event"]["name"],
                       tuple(auto["missing_ranks"])))
            assert first == {(4, "d.skipped", (skipper,))}, (first, heads)
            assert all(h["outcome"].startswith(
                "collective d.skipped aborted") for h in heads
                if h["rank"] != skipper), heads
            assert max(h["report_s"] for h in heads) <= \
                EAGER_DESYNC_BOUND_S, heads
            emit({"phase": "eager_cards_desync", "cards": n,
                  "skipped_by_rank": skipper,
                  "abort_after_s": EAGER_DESYNC_ABORT_S,
                  "bound_s": EAGER_DESYNC_BOUND_S, "ranks": heads,
                  "coordinator_report": {
                      "first_divergent_seq": auto["first_divergent_seq"],
                      "name": auto["divergent_event"]["name"],
                      "missing_ranks": auto["missing_ranks"],
                      "stall_age_s": auto["stall_age_s"]}})
        hvd.shutdown()
    except BaseException:
        import traceback

        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)
    return 0


# ---- the data-parallel step made whole: SyncBN, accumulation, the wire in a
# ---- graph, VGG-16 and the MLP (one card), then --dp-cards N ----------------

DP_STEPS = 3
# Kernel names in a torch.profiler trace, by kernel of the path: each name
# part matches that kernel's CUDA function (quant8_kernel is a part of
# dequant8_kernel's name, so the dequantize kernels are matched first).
REPLAY_KERNELS = (("_mm_stats_kernel", "mm_stats_kernel"),
                  ("_sgd_kernel", "optim_multi<false>"),
                  ("_adam_kernel", "optim_multi<true>"),
                  ("_dequant_kernel", "dequant8_kernel"),
                  ("_quant_kernel", "quant8_kernel"),
                  ("_dequant4_kernel", "dequant4_kernel"),
                  ("_quant4_kernel", "quant4_kernel"),
                  ("nccl", "nccl"))


def replay_kernels(fn, table=REPLAY_KERNELS) -> dict:
    """The kernels one call of ``fn`` launches on the card, by ``table``
    (:data:`REPLAY_KERNELS` by default; torch.profiler: a graph replay's
    kernels are traced one by one)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {name: 0 for name, _ in table}
    total = 0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        total += 1
        key = e.name.lower()
        for name, part in table:
            if part in key:
                out[name] += 1
                break
    out["all"] = total
    return out


def _resnet_step(model, opt, images, labels):
    from horovod_tpu_torch.models import resnet_loss

    opt.zero_grad(set_to_none=True)
    loss, _ = resnet_loss(model, images, labels)
    loss.backward()
    opt.step()
    return loss.detach()


def _vgg_step(model, opt, images, labels):
    from horovod_tpu_torch.models import vgg_loss

    opt.zero_grad(set_to_none=True)
    loss = vgg_loss(model, images, labels)
    loss.backward()
    opt.step()
    return loss.detach()


def _mlp_step(model, opt, x, labels):
    from horovod_tpu_torch.models import mlp_loss

    opt.zero_grad(set_to_none=True)
    loss = mlp_loss(model, x, labels)
    loss.backward()
    opt.step()
    return loss.detach()


def _dp_opt(hvd, model, *, k=1, wire=None, lr=0.01):
    """DistributedOptimizer(fused_sgd(lr, momentum 0.9)) over ``wire``
    (None: the exact wire; "int8"/"int4" under with_error_feedback)."""
    comp = {None: hvd.Compression.none, "int8": hvd.Compression.int8,
            "int4": hvd.Compression.int4}[wire]
    opt = hvd.DistributedOptimizer(
        hvd.fused_sgd(model.parameters(), lr, momentum=0.9),
        compression=comp, backward_passes_per_step=k)
    return hvd.quant.with_error_feedback(opt, wire=wire) if wire else opt


def _state_of(model, opt, losses) -> dict:
    """Copies of what a graphed and an eager run must share: the losses,
    the model's state, the optimizer's state and error-feedback
    residuals."""
    out = {"losses": torch.stack(losses)}
    out.update({k: v.detach().clone() for k, v in model.state_dict().items()})
    inner = opt
    while not isinstance(inner, torch.optim.Optimizer):
        if "residual" in vars(inner):
            out.update({f"residual{i}": r.clone()
                        for i, r in enumerate(inner.residual.values())})
        inner = inner.optimizer
    for i, st in enumerate(inner.state.values()):
        out.update({f"state{i}.{k}": v.clone() for k, v in st.items()
                    if isinstance(v, torch.Tensor)})
    return out


def _runs_err(got: dict, want: dict) -> float:
    assert got.keys() == want.keys()
    return max(_bit_err(got[k], want[k]) for k in got)


def _dp_run(hvd, graphed, batches, calls, *, bn_axis=None, k=1, wire=None,
            make_model=None, step_fn=None, lr=0.01):
    """``calls`` steps of a fresh model (ResNet-50 at ``bn_axis`` unless
    ``make_model``), broadcast from rank 0, under :func:`_dp_opt`; call i
    takes ``batches[i % len(batches)]``.  Returns (model, opt, step,
    state) with the state from :func:`_state_of`."""
    from horovod_tpu_torch.models import ResNetConfig, resnet50_init
    from horovod_tpu_torch.step_pipeline import donated_step

    if make_model is None:
        model = resnet50_init(0, ResNetConfig(bn_axis=bn_axis))
    else:
        model = make_model()
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = _dp_opt(hvd, model, k=k, wire=wire, lr=lr)
    fn = step_fn or _resnet_step
    step = donated_step(fn) if graphed else fn
    losses = [step(model, opt, *batches[i % len(batches)]).clone()
              for i in range(calls)]
    torch.cuda.synchronize()
    return model, opt, step, _state_of(model, opt, losses)


def _graphed_ms(call, steps: int = 10, reps: int = 3) -> dict:
    """Device-clock ms a call over ``reps`` runs of ``steps`` calls back
    to back (CUDA events; every rank starts together when a process
    group exists)."""
    import torch.distributed as dist

    call()
    times = []
    for _ in range(reps):
        if dist.is_initialized() and dist.get_world_size() > 1:
            dist.barrier()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(steps):
            call()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / steps)
    return _stats(times)


def _free():
    """Return the card's memory once the caller has dropped its
    references (graphs, models, optimizers)."""
    gc.collect()
    torch.cuda.empty_cache()


def _bf16_batch(seed, batch, image=IMAGE, classes=1000):
    g = torch.Generator(device="cuda").manual_seed(seed)
    images = torch.randn((batch, image, image, 3), generator=g,
                         device="cuda", dtype=torch.bfloat16)
    labels = torch.randint(0, classes, (batch,), generator=g, device="cuda")
    return images, labels


def phase_sync_bn(hvd, smi):
    """SyncBN on the main path in the NCCL world of one: the bs-64
    ResNet-50 step with bn_axis="dp", HVDT_FUSED_CONV1X1=1, under
    DistributedOptimizer(fused_sgd), graphed by donated_step, against
    the same step eagerly and against bn_axis=None graphed (a world of
    one: every byte the same); #4's launches on a replay (26 a forward)
    and the step's ms against bn_axis=None's, in turns."""
    os.environ["HVDT_FUSED_CONV1X1"] = "1"
    torch.backends.cudnn.deterministic = True
    try:
        batch = [_bf16_batch(11, BATCH)]
        reset_counters()
        model, opt, step, dp = _dp_run(hvd, True, batch, DP_STEPS,
                                       bn_axis="dp")
        launches = counters()
        assert launches["_mm_stats_kernel"] == 26 * 2, launches
        assert launches["_sgd_kernel"] == 2, launches
        assert all(math.isfinite(x) for x in dp["losses"].tolist())
        per_replay = replay_kernels(lambda: step(model, opt, *batch[0]))
        assert per_replay["_mm_stats_kernel"] == 26, per_replay
        assert per_replay["_sgd_kernel"] == 1, per_replay
        eager = _dp_run(hvd, False, batch, DP_STEPS, bn_axis="dp")[3]
        err_eager = _runs_err(dp, eager)
        assert err_eager == 0.0, err_eager
        m0, o0, s0, none = _dp_run(hvd, True, batch, DP_STEPS)
        err_none = _runs_err(dp, none)
        assert err_none == 0.0, err_none
        ms = {"dp": [], "none": []}
        for name in ("dp", "none", "none", "dp"):
            st, mo, op = (step, model, opt) if name == "dp" else (s0, m0, o0)
            ms[name].append(_graphed_ms(lambda: st(mo, op, *batch[0])))
        emit({"phase": "sync_bn", "model": "resnet50", "batch": BATCH,
              "bn_axis": "dp", "steps": DP_STEPS,
              "losses": dp["losses"].tolist(), "launches": launches,
              "kernels_per_replay": per_replay,
              "graphed_vs_eager_max_abs_err": err_eager,
              "vs_bn_axis_none_max_abs_err": err_none,
              "tensors": len(dp), "tolerance": 0.0,
              "step_ms": ms["dp"], "bn_axis_none_step_ms": ms["none"],
              "card": smi})
        del model, opt, step, m0, o0, s0
        _free()
    finally:
        torch.backends.cudnn.deterministic = False


def phase_accumulate(hvd, smi):
    """backward_passes_per_step k = 2 and 4 under donated_step (one graph
    a pass of the cycle) against the eager k-pass steps, bit for bit, on
    the bs-64 ResNet-50 batch cut into k micro-batches; the kernels of
    each pass's replay (no NCCL kernel on a non-boundary replay; the SGD
    kernel only on the boundary); then microbatch_gradients with k = 4
    against the gradients one k = 4 accumulation hands the optimizer."""
    os.environ["HVDT_FUSED_CONV1X1"] = "1"
    torch.backends.cudnn.deterministic = True
    try:
        images, labels = _bf16_batch(12, BATCH)
        rows = {}
        for k in (2, 4):
            micro = list(zip(images.chunk(k), labels.chunk(k)))
            reset_counters()
            model, opt, step, got = _dp_run(hvd, True, micro, 3 * k, k=k)
            launches = counters()
            assert launches["_sgd_kernel"] == 2, launches
            assert len(step._graphs) == k
            want = _dp_run(hvd, False, micro, 3 * k, k=k)[3]
            err = _runs_err(got, want)
            assert err == 0.0, (k, err)
            per_pass = {}
            for key, cap in sorted(step._graphs.items()):
                per_pass[str(key[0])] = replay_kernels(cap.graph.replay)
            for key, kern in per_pass.items():
                boundary = int(key) == k - 1
                assert kern["_mm_stats_kernel"] == 26, (key, kern)
                assert kern["_sgd_kernel"] == int(boundary), (key, kern)
                if not boundary:
                    assert kern["nccl"] == 0, (key, kern)
            rows[k] = {"graphs": len(step._graphs), "passes": 3 * k,
                       "launches": launches,
                       "graphed_vs_eager_max_abs_err": err,
                       "kernels_per_replay_by_pass": per_pass,
                       "pass_ms": _graphed_ms(
                           lambda: step(model, opt, *micro[0]), steps=k)}
            del model, opt, step
            _free()

        # microbatch_gradients (k = 4) against one k = 4 accumulation.
        from horovod_tpu_torch.models import (ResNetConfig, resnet50_init,
                                              resnet_loss)

        micro = list(zip(images.chunk(4), labels.chunk(4)))
        model = resnet50_init(0, ResNetConfig())
        opt = _dp_opt(hvd, model, k=4)
        for x, y in micro:
            _resnet_step(model, opt, x, y)
        acc = [p.grad.clone() for p in model.parameters()]
        model = resnet50_init(0, ResNetConfig())
        params = list(model.parameters())

        def grad_fn(ps, mb):
            loss, _ = resnet_loss(model, *mb)
            return torch.autograd.grad(loss, ps)

        reset_counters()
        mb = hvd.microbatch_gradients(grad_fn, params, (images, labels), 4)
        mb_launches = counters()
        torch.cuda.synchronize()
        mb_err = max(_bit_err(a.contiguous(), b.contiguous())
                     for a, b in zip(mb, acc))
        assert mb_err == 0.0, mb_err
        emit({"phase": "accumulate", "model": "resnet50", "batch": BATCH,
              "k": rows, "microbatch_vs_accumulation_max_abs_err": mb_err,
              "microbatch_launches": mb_launches, "tolerance": 0.0,
              "card": smi})
        del model, opt, acc, mb
        _free()
    finally:
        torch.backends.cudnn.deterministic = False


def phase_wire_graphed(hvd, smi):
    """The int8 and int4 wires under with_error_feedback(
    DistributedOptimizer(...)) graphed against eager over 3 steps
    (parameters, momentum and residuals bit-identical), the quantize and
    dequantize kernels a replay launches, and the graphed step's ms
    against the eager step's, in turns."""
    os.environ["HVDT_FUSED_CONV1X1"] = "1"
    torch.backends.cudnn.deterministic = True
    try:
        batch = [_bf16_batch(13, BATCH)]
        rows = {}
        for wire in ("int8", "int4"):
            reset_counters()
            model, opt, step, got = _dp_run(hvd, True, batch, DP_STEPS,
                                            wire=wire)
            launches = counters()
            em, eo, _, want = _dp_run(hvd, False, batch, DP_STEPS, wire=wire)
            err = _runs_err(got, want)
            assert err == 0.0, (wire, err)
            want_q, want_dq = expected_quant_launches(hvd, model, 1, wire)
            kern = replay_kernels(lambda: step(model, opt, *batch[0]))
            q, dq = (("_quant4_kernel", "_dequant4_kernel") if wire == "int4"
                     else ("_quant_kernel", "_dequant_kernel"))
            assert (kern[q], kern[dq]) == (want_q, want_dq), (wire, kern)
            assert launches[q] == 2 * want_q, (wire, launches)

            def eager_step():
                _resnet_step(em, eo, *batch[0])

            graphed = lambda: step(model, opt, *batch[0])  # noqa: E731
            ms = {"graphed": [], "eager": []}
            for name in ("graphed", "eager", "eager", "graphed"):
                ms[name].append(_graphed_ms(
                    graphed if name == "graphed" else eager_step, steps=5))
            rows[wire] = {"launches": launches, "kernels_per_replay": kern,
                          "expected_quant_dequant_per_step": [want_q,
                                                              want_dq],
                          "graphed_vs_eager_max_abs_err": err,
                          "tensors": len(got), "graphed_step_ms": ms[
                              "graphed"], "eager_step_ms": ms["eager"]}
            del model, opt, step, em, eo
            _free()
        emit({"phase": "wire_graphed", "model": "resnet50", "batch": BATCH,
              "steps": DP_STEPS, "wires": rows, "tolerance": 0.0,
              "card": smi})
    finally:
        torch.backends.cudnn.deterministic = False


def vgg_step_flops(cfg, batch: int) -> float:
    """FLOPs of one VGG training step (convolutions and matmuls, 2 a
    multiply-add), counted by FlopCounterMode on the meta device, as the
    bench counts ResNet-50's."""
    from torch.utils.flop_counter import FlopCounterMode

    from horovod_tpu_torch.models import vgg16_init, vgg_loss

    model = vgg16_init(0, cfg, device="meta")
    images = torch.empty((batch, cfg.image_size, cfg.image_size, 3),
                         device="meta")
    labels = torch.zeros((batch,), dtype=torch.long, device="meta")
    with FlopCounterMode(display=False) as counter:
        vgg_loss(model, images, labels).backward()
    return float(counter.get_total_flops())


VGG_BATCH = 64
MLP_BATCH = 64
# VGG has no BatchNorm: SGD at 0.01 with momentum 0.9 on one repeated
# batch diverges within a few steps, so its phases step at 1e-3.
VGG_LR = 1e-3


def phase_vgg_mlp(hvd, smi):
    """VGG-16 (configuration D, 224x224, 1000 classes, bf16 compute, f32
    params, batch 64) under DistributedOptimizer(fused_sgd), 3 graphed
    steps, then its step ms, img/s and MFU; the MLP (784-256-128-10,
    batch 64) for 3 graphed steps."""
    from horovod_tpu_torch.models import VGGConfig, mlp_init, vgg16_init

    cfg = VGGConfig()
    batch = [_bf16_batch(14, VGG_BATCH)]
    reset_counters()
    model, opt, step, got = _dp_run(
        hvd, True, batch, DP_STEPS, make_model=lambda: vgg16_init(0, cfg),
        step_fn=_vgg_step, lr=VGG_LR)
    launches = counters()
    losses = got["losses"].tolist()
    assert all(math.isfinite(x) for x in losses), losses
    assert launches["_sgd_kernel"] == 2, launches
    n_params = sum(p.numel() for p in model.parameters())
    ms = _graphed_ms(lambda: step(model, opt, *batch[0]))
    flops = vgg_step_flops(cfg, VGG_BATCH)
    step_s = ms["median"] / 1e3
    emit({"phase": "vgg", "model": "vgg16", "batch": VGG_BATCH,
          "image": cfg.image_size, "params": n_params, "losses": losses,
          "launches": launches, "step_ms": ms,
          "images_per_s": VGG_BATCH / step_s, "flops_per_step": flops,
          "mfu": flops / step_s / PEAK_BF16_FLOPS, "card": smi})
    del model, opt, step
    _free()

    g = torch.Generator(device="cuda").manual_seed(15)
    x = torch.randn((MLP_BATCH, 784), generator=g, device="cuda")
    y = torch.randint(0, 10, (MLP_BATCH,), generator=g, device="cuda")
    reset_counters()
    model, opt, step, got = _dp_run(
        hvd, True, [(x, y)], DP_STEPS, make_model=lambda: mlp_init(0),
        step_fn=_mlp_step)
    mlp_launches = counters()
    losses = got["losses"].tolist()
    assert all(math.isfinite(v) for v in losses), losses
    assert mlp_launches["_sgd_kernel"] == 2, mlp_launches
    emit({"phase": "mlp", "model": "mlp", "sizes": [784, 256, 128, 10],
          "batch": MLP_BATCH, "losses": losses, "launches": mlp_launches,
          "step_ms": _graphed_ms(lambda: step(model, opt, x, y)),
          "card": smi})
    del model, opt, step
    _free()


# ---- python3 chip_smoke.py --dp-cards N: the data-parallel step across N
# ---- cards --------------------------------------------------------------------

DP_CARDS_TIMEOUT_S = 900
DP_CHECK_BATCH, DP_TIME_BATCH = 32, 128
# The dp run's first step against one card running the global batch with
# bn_axis=None.  At random init ResNet-50's gradients are ill-conditioned:
# on the CPU, merely reordering the images of one f32 batch moved them by
# 2.8% relative L2 (ResNet-50, 16 images of 160x160, unfused), and in bf16
# by 111%, as large as the gradients themselves.  So the gradients are
# held in f32 (unfused: the fused kernels take 16-bit operands), against
# twice what reordering the global batch does on the same card, plus
# 1e-3; the loss within 1e-4 relative in f32 and 5e-2 in bf16 (the
# graphed run's first loss, fused convs).
DP_F32_LOSS_TOL, DP_BF16_LOSS_TOL = 1e-4, 5e-2


def _rel_l2(got, want) -> float:
    diff = sum(float((a.double() - b.double()).norm()) ** 2
               for a, b in zip(got, want)) ** 0.5
    return diff / sum(float(b.double().norm()) ** 2 for b in want) ** 0.5


def _global_f32_grads(x, y):
    """One card: the f32 (unfused) ResNet-50 loss and gradients of the
    global batch ``(x, y)`` with bn_axis=None, and the relative L2 by
    which reordering the batch moves the gradients (the yardstick)."""
    from horovod_tpu_torch.models import (ResNetConfig, resnet50_init,
                                          resnet_loss)

    perm = torch.randperm(x.shape[0], generator=torch.Generator().manual_seed(
        0)).to(x.device)
    runs = []
    os.environ["HVDT_FUSED_CONV1X1"] = "0"
    try:
        for order in (None, perm):
            ref = resnet50_init(0, ResNetConfig(dtype=torch.float32))
            xs, ys = (x, y) if order is None else (x[order], y[order])
            want, _ = resnet_loss(ref, xs, ys)
            want.backward()
            runs.append((want.item(), [p.grad for p in ref.parameters()]))
            del ref, xs, ys
            _free()
    finally:
        os.environ["HVDT_FUSED_CONV1X1"] = "1"
    (want, want_g), (_, perm_g) = runs
    return want, want_g, _rel_l2(perm_g, want_g)


def _global_batch_check(hvd, images, labels, loss_bf16) -> dict:
    """The first step of the dp run in f32 (bn_axis="dp", unfused, one
    exchange of the gradients) against one card running the global batch
    with bn_axis=None, with the reordered global batch as the yardstick;
    ``loss_bf16`` is the graphed bf16 run's first loss averaged over the
    ranks, held against the global batch's bf16 loss.  Collective: every
    rank calls it; rank 0 returns the result."""
    import torch.distributed as dist

    from horovod_tpu_torch.models import (ResNetConfig, resnet50_init,
                                          resnet_loss)

    n, r = dist.get_world_size(), dist.get_rank()
    everyone = [torch.empty_like(images) for _ in range(n)]
    dist.all_gather(everyone, images)
    every_label = [torch.empty_like(labels) for _ in range(n)]
    dist.all_gather(every_label, labels)
    os.environ["HVDT_FUSED_CONV1X1"] = "0"
    f32 = ResNetConfig(dtype=torch.float32, bn_axis="dp")
    model = resnet50_init(0, f32)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    loss, _ = resnet_loss(model, images.float(), labels)
    loss.backward()
    grads = hvd.allreduce_gradients([p.grad for p in model.parameters()])
    loss = hvd.allreduce_gradients([loss.detach()])[0]
    del model
    _free()
    os.environ["HVDT_FUSED_CONV1X1"] = "1"
    if r:
        return None
    x, y = torch.cat(everyone).float(), torch.cat(every_label)
    want, want_g, floor = _global_f32_grads(x, y)
    with torch.no_grad():
        ref = resnet50_init(0, ResNetConfig())
        want_bf16, _ = resnet_loss(ref, x.to(torch.bfloat16), y)
        del ref
    _free()
    out = {"f32_loss": float(loss), "f32_global_batch_loss": want,
           "f32_loss_rel_err": abs(float(loss) - want) / abs(want),
           "f32_grads_rel_l2": _rel_l2(grads, want_g),
           "f32_reordered_batch_grads_rel_l2": floor,
           "bf16_loss": loss_bf16, "bf16_global_batch_loss": float(
               want_bf16),
           "bf16_loss_rel_err": abs(loss_bf16 - float(want_bf16))
           / abs(float(want_bf16)),
           "tolerance": {"f32_loss": DP_F32_LOSS_TOL,
                         "f32_grads": "2 x reordered + 1e-3",
                         "bf16_loss": DP_BF16_LOSS_TOL}}
    assert out["f32_loss_rel_err"] <= DP_F32_LOSS_TOL, out
    assert out["f32_grads_rel_l2"] <= 2 * floor + 1e-3, out
    assert out["bf16_loss_rel_err"] <= DP_BF16_LOSS_TOL, out
    return out


# #4 under axis= across the cards, op by op (_fused_sync_check): each
# rank's shard has its own scale and offset, so statistics taken per rank
# miss the global ones by O(1) (the check also runs axis=None on the
# local shard as its yardstick, which must fail every tolerance below
# but dbeta's: without a ReLU, dbeta does not read the statistics).
# mean in units of the global standard deviation, var relative, y
# relative to |y| + 1 (a bf16 output: one ulp is 2^-8 relative), the
# gradients relative L2 after the sum over the ranks.
DP_FUSED_TOL = {"mean": 1e-3, "var": 1e-3, "y": 1e-2, "dx": 1e-2,
                "dw": 1e-2, "dgamma": 1e-3, "dbeta": 1e-3}


def _fused_shapes() -> list:
    """(x shape, w shape, relu) of each distinct conv1x1_bn_train call in
    ResNet-50's train forward at DP_CHECK_BATCH a card (bn_axis="dp",
    HVDT_FUSED_CONV1X1=1), in call order.  Collective (the forward's
    SyncBN all-reduces): every rank calls it."""
    from horovod_tpu_torch.models import (ResNetConfig, resnet50_init,
                                          resnet_loss)
    from horovod_tpu_torch.models import resnet as rn

    shapes = {}
    real = rn.conv1x1_bn_train

    def record(x, w, *args, relu=True, **kw):
        shapes.setdefault((tuple(x.shape), tuple(w.shape), relu), None)
        return real(x, w, *args, relu=relu, **kw)

    rn.conv1x1_bn_train = record
    try:
        model = resnet50_init(0, ResNetConfig(bn_axis="dp"))
        with torch.no_grad():
            resnet_loss(model, *_bf16_batch(7, DP_CHECK_BATCH))
    finally:
        rn.conv1x1_bn_train = real
    del model
    _free()
    return list(shapes)


def _fused_sync_check(shapes, device="cuda") -> dict:
    """conv1x1_bn_train(axis="dp") on each rank's shard against
    conv1x1_bn_train(axis=None) on the global batch (every rank's shard,
    made from seeds on every rank), at each of ``shapes`` (bf16 operands,
    f32 gamma/beta): batch mean and variance, the rank's rows of y and
    dx, and dw/dgamma/dbeta summed over the ranks (the reference's
    convention for a replicated parameter).  The same with axis=None on
    the local shard is the yardstick.  Largest error over shapes and
    ranks, each held to DP_FUSED_TOL.  Collective: every rank calls it;
    every rank returns the result."""
    import torch.distributed as dist

    from horovod_tpu_torch.ops.conv_fused import conv1x1_bn_train

    r, n = dist.get_rank(), dist.get_world_size()

    def rand(shape, seed, scale=1.0, offset=0.0, dtype=torch.bfloat16):
        g = torch.Generator(device=device).manual_seed(seed)
        t = torch.randn(shape, generator=g, device=device)
        return (t * scale + offset).to(dtype)

    def run(x, dy, w, gamma, beta, relu, axis):
        x, w, gamma, beta = (t.clone().requires_grad_()
                             for t in (x, w, gamma, beta))
        y, mean, var = conv1x1_bn_train(x, w, gamma, beta, relu=relu,
                                        axis=axis)
        y.backward(dy)
        return {"mean": mean.detach(), "var": var.detach(),
                "y": y.detach(), "dx": x.grad, "dw": w.grad.float(),
                "dgamma": gamma.grad, "dbeta": beta.grad}

    def summed(out):
        for key in ("dw", "dgamma", "dbeta"):
            dist.all_reduce(out[key])
        return out

    def errors(got, want, var, rows):
        inv_sd = torch.rsqrt(var + 1e-5)
        y, wy = got["y"].float(), want["y"][rows].float()
        return {"mean": float(((got["mean"] - want["mean"]).abs()
                               * inv_sd).max()),
                "var": float(((got["var"] - var).abs() / (var + 1e-5))
                             .max()),
                "y": float(((y - wy).abs() / (wy.abs() + 1)).max()),
                "dx": _rel_l2([got["dx"]], [want["dx"][rows]]),
                **{k: _rel_l2([got[k]], [want[k]])
                   for k in ("dw", "dgamma", "dbeta")}}

    worst = {"synced": dict.fromkeys(DP_FUSED_TOL, 0.0),
             "per_rank": dict.fromkeys(DP_FUSED_TOL, math.inf)}
    for i, (xshape, wshape, relu) in enumerate(shapes):
        yshape = xshape[:-1] + wshape[1:]
        xs = [rand(xshape, 1000 * i + q, 1 + q, q) for q in range(n)]
        dys = [rand(yshape, 1000 * i + 500 + q, 1 + q, q) for q in range(n)]
        w = rand(wshape, 1000 * i + 900, wshape[0] ** -0.5)
        gamma = rand(wshape[1:], 1000 * i + 901, 0.1, 1.0, torch.float32)
        beta = rand(wshape[1:], 1000 * i + 902, 0.1, 0.0, torch.float32)
        synced = summed(run(xs[r], dys[r], w, gamma, beta, relu, "dp"))
        alone = summed(run(xs[r], dys[r], w, gamma, beta, relu, None))
        want = run(torch.cat(xs), torch.cat(dys), w, gamma, beta, relu,
                   None)
        rows = slice(r * xshape[0], (r + 1) * xshape[0])
        for name, got, pick in (("synced", synced, max),
                                ("per_rank", alone, min)):
            for k, e in errors(got, want, want["var"], rows).items():
                worst[name][k] = pick(worst[name][k], e)
        del xs, dys, synced, alone, want
    for name, op in (("synced", dist.ReduceOp.MAX),
                     ("per_rank", dist.ReduceOp.MIN)):
        t = torch.tensor(list(worst[name].values()), dtype=torch.float64,
                         device=device)
        dist.all_reduce(t, op)
        worst[name] = dict(zip(worst[name], t.tolist()))
    out = {"shapes": len(shapes), "max_err": worst["synced"],
           "per_rank_stats_min_err": worst["per_rank"],
           "tolerance": DP_FUSED_TOL}
    for k, tol in DP_FUSED_TOL.items():
        assert out["max_err"][k] <= tol, (k, out)
        assert k == "dbeta" or out["per_rank_stats_min_err"][k] > tol, \
            (k, out)
    return out


def _same_on_every_rank(tensors) -> bool:
    """Every rank holds rank 0's bytes of ``tensors``."""
    import torch.distributed as dist

    blob = torch.cat([t.detach().reshape(-1).view(torch.uint8)
                      for t in tensors])
    ref = blob.clone()
    dist.broadcast(ref, 0)
    ok = torch.tensor([int(torch.equal(ref, blob))], device=blob.device)
    dist.all_reduce(ok, dist.ReduceOp.MIN)
    return bool(ok.item())


def _wire_bytes_per_rank(hvd, model, wire, n) -> dict:
    """Bytes one rank sends in one exchange of the model's gradients, from
    the bucket plan: the two-stage quantized wire sends (n-1) shards of
    payload and scales in its all_to_all and (n-1) in its all_gather; the
    exact wire's ring allreduce sends 2 (n-1)/n of each f32 bucket."""
    from horovod_tpu_torch.quant import kernels as qk

    grads = [p for p in model.parameters()]
    block = qk.quant_block_size()
    quant = exact = 0
    for bucket in hvd.device.fused_allreduce_buckets(grads, None):
        size = sum(grads[i].numel() for i in bucket)
        shard = -(-size // (n * block)) * block
        payload = shard // 2 if wire == "int4" else shard
        quant += 2 * (n - 1) * (payload + 4 * shard // block)
        exact += 2 * (n - 1) * size * 4 // n
    return {"quantized": quant, "f32_ring": exact}


def dp_check(hvd, smi):
    """dp_cards: ResNet-50 with bn_axis="dp", fused convs and
    DistributedOptimizer(fused_sgd), graphed, at batch 32 a card: state
    bit-identical on every rank after 3 steps; the first step against
    one card running the global batch (:func:`_global_batch_check`)."""
    import torch.distributed as dist

    r, n = dist.get_rank(), dist.get_world_size()
    t0 = time.perf_counter()
    batch = [_bf16_batch(100 + r, DP_CHECK_BATCH)]
    reset_counters()
    model, opt, step, got = _dp_run(hvd, True, batch, DP_STEPS,
                                    bn_axis="dp")
    launches = counters()
    assert launches["_mm_stats_kernel"] == 26 * 2, launches
    assert launches["_sgd_kernel"] == 2, launches
    same = _same_on_every_rank([v for k, v in got.items() if k != "losses"])
    assert same
    per_replay = replay_kernels(lambda: step(model, opt, *batch[0]))
    loss0 = got["losses"][:1].clone()
    dist.all_reduce(loss0)
    del model, opt, step
    _free()
    check = _global_batch_check(hvd, *batch[0], float(loss0) / n)
    fused = _fused_sync_check(_fused_shapes())
    if r == 0:
        emit({"phase": "dp_cards", "cards": n, "model": "resnet50",
              "batch_per_card": DP_CHECK_BATCH, "bn_axis": "dp",
              "steps": DP_STEPS, "losses_rank0": got["losses"].tolist(),
              "state_identical_on_every_rank": same,
              "first_step_vs_one_card_global_batch": check,
              "fused_sync_bn_vs_one_card_global_batch": fused,
              "launches_rank0": launches,
              "kernels_per_replay_rank0": per_replay,
              "wall_s": time.perf_counter() - t0, "card": smi})


def dp_time(hvd, smi):
    """dp_cards_time: batch 128 a card, graphed, cuDNN's default
    algorithms as the one-card bench leg: the step with the exchange and
    the SyncBN collectives, with one of them and with neither; img/s a
    card and the scaling efficiency against leg G."""
    import torch.distributed as dist

    from horovod_tpu_torch.models import ResNetConfig, resnet50_init
    from horovod_tpu_torch.step_pipeline import donated_step

    r, n = dist.get_rank(), dist.get_world_size()
    t0 = time.perf_counter()
    torch.backends.cudnn.deterministic = False
    batch = _bf16_batch(200 + r, DP_TIME_BATCH)
    times = {}
    variants = {"full": ("dp", True), "exchange_only": (None, True),
                "syncbn_only": ("dp", False), "local": (None, False)}
    for name in ("full", "exchange_only", "syncbn_only", "local", "full"):
        axis, exchange = variants[name]
        model = resnet50_init(0, ResNetConfig(bn_axis=axis))
        hvd.broadcast_parameters(model.state_dict(), root_rank=0)
        inner = hvd.fused_sgd(model.parameters(), 0.01, momentum=0.9)
        opt = hvd.DistributedOptimizer(inner) if exchange else inner
        step = donated_step(_resnet_step)
        step(model, opt, *batch)
        kern = replay_kernels(lambda: step(model, opt, *batch))
        times.setdefault(name, []).append(
            {**_graphed_ms(lambda: step(model, opt, *batch)),
             "nccl_kernels_per_step": kern["nccl"]})
        del model, opt, inner, step
        _free()
    torch.backends.cudnn.deterministic = True
    if r == 0:
        full = min(t["median"] for t in times["full"])
        per_card = DP_TIME_BATCH / (full / 1e3)
        one_card = float(os.environ.get("CHIP_SMOKE_LEG_G_IMG_S", "nan"))
        emit({"phase": "dp_cards_time", "cards": n, "model": "resnet50",
              "batch_per_card": DP_TIME_BATCH, "step_ms": times,
              "images_per_s_per_card": per_card,
              "images_per_s": per_card * n,
              "one_card_leg_g_images_per_s": one_card,
              "scaling_efficiency": per_card / one_card,
              "exchange_and_syncbn_share": 1 - min(
                  t["median"] for t in times["local"]) / full,
              "wall_s": time.perf_counter() - t0, "card": smi})


def dp_wire(hvd, smi):
    """dp_cards_wire: the int8 and int4 wires under error feedback,
    graphed against eager on every rank, with the bytes each rank
    sends."""
    import torch.distributed as dist

    r, n = dist.get_rank(), dist.get_world_size()
    t0 = time.perf_counter()
    batch = [_bf16_batch(300 + r, DP_CHECK_BATCH)]
    rows = {}
    for wire in ("int8", "int4"):
        model, opt, step, got = _dp_run(hvd, True, batch, DP_STEPS,
                                        wire=wire, bn_axis="dp")
        want = _dp_run(hvd, False, batch, DP_STEPS, wire=wire,
                       bn_axis="dp")[3]
        err = _runs_err(got, want)
        assert err == 0.0, (wire, err)
        shared = [v for k, v in got.items()
                  if k != "losses" and not k.startswith("residual")]
        same = _same_on_every_rank(shared)
        assert same, wire
        rows[wire] = {"graphed_vs_eager_max_abs_err": err,
                      "state_identical_on_every_rank": same,
                      "bytes_sent_per_rank": _wire_bytes_per_rank(
                          hvd, model, wire, n),
                      "kernels_per_replay": replay_kernels(
                          lambda: step(model, opt, *batch[0]))}
        del model, opt, step
        _free()
    if r == 0:
        emit({"phase": "dp_cards_wire", "cards": n, "model": "resnet50",
              "batch_per_card": DP_CHECK_BATCH, "steps": DP_STEPS,
              "wires": rows, "tolerance": 0.0,
              "wall_s": time.perf_counter() - t0, "card": smi})


def dp_vgg(hvd, smi):
    """dp_cards_vgg: VGG-16 at batch 64 a card over the exact and the
    int8 wire: the graphed step and one exchange of its gradients."""
    import torch.distributed as dist

    from horovod_tpu_torch.models import VGGConfig, vgg16_init

    r, n = dist.get_rank(), dist.get_world_size()
    t0 = time.perf_counter()
    torch.backends.cudnn.deterministic = False
    batch = [_bf16_batch(400 + r, VGG_BATCH)]
    rows = {}
    for wire in (None, "int8"):
        model, opt, step, _ = _dp_run(
            hvd, True, batch, 2, wire=wire,
            make_model=lambda: vgg16_init(0, VGGConfig()), step_fn=_vgg_step,
            lr=VGG_LR)
        grads = [p.grad for p in model.parameters()]
        sentinel = hvd.quant.INT8_WIRE if wire else None
        rows[wire or "f32"] = {
            "step_ms": _graphed_ms(lambda: step(model, opt, *batch[0])),
            "exchange_ms": _graphed_ms(lambda: hvd.device.fused_allreduce(
                grads, wire_dtype=sentinel)),
            "gradient_bytes": sum(g.numel() * g.element_size()
                                  for g in grads),
            "bytes_sent_per_rank": _wire_bytes_per_rank(hvd, model, "int8",
                                                        n)}
        del model, opt, step, grads
        _free()
    torch.backends.cudnn.deterministic = True
    if r == 0:
        emit({"phase": "dp_cards_vgg", "cards": n, "model": "vgg16",
              "batch_per_card": VGG_BATCH, "wires": rows,
              "wall_s": time.perf_counter() - t0, "card": smi})


def dp_accumulate(hvd, smi):
    """dp_cards_accumulate: k = 2 across the cards (no SyncBN, so the
    exchange is the only collective), graphed against eager: NCCL
    kernels only on the boundary pass."""
    import torch.distributed as dist

    r, n = dist.get_rank(), dist.get_world_size()
    t0 = time.perf_counter()
    images, labels = _bf16_batch(500 + r, DP_CHECK_BATCH)
    micro = list(zip(images.chunk(2), labels.chunk(2)))
    model, opt, step, got = _dp_run(hvd, True, micro, 6, k=2)
    want = _dp_run(hvd, False, micro, 6, k=2)[3]
    err = _runs_err(got, want)
    assert err == 0.0, err
    per_pass = {str(key[0]): replay_kernels(cap.graph.replay)
                for key, cap in sorted(step._graphs.items())}
    assert per_pass["0"]["nccl"] == 0 < per_pass["1"]["nccl"], per_pass
    # Without SyncBN each rank keeps its own BN running statistics.
    same = _same_on_every_rank([v for k, v in got.items() if k != "losses"
                                and not k.endswith((".mean", ".var"))])
    assert same
    if r == 0:
        emit({"phase": "dp_cards_accumulate", "cards": n, "k": 2,
              "batch_per_card": DP_CHECK_BATCH, "passes": 6,
              "graphed_vs_eager_max_abs_err": err,
              "state_identical_on_every_rank": same,
              "kernels_per_replay_by_pass": per_pass,
              "wall_s": time.perf_counter() - t0, "card": smi})
    del model, opt, step
    _free()


def _exchanged_grads(hvd, model, opt, images, labels):
    """One backward and ``opt.synchronize()``: the exchanged gradients
    (copies), with no optimizer step."""
    from horovod_tpu_torch.models import resnet_loss

    opt.zero_grad(set_to_none=True)
    loss, _ = resnet_loss(model, images, labels)
    loss.backward()
    opt.synchronize()
    torch.cuda.synchronize()
    return [p.grad.detach().clone() for p in model.parameters()]


def _max_rel_l2(got, want) -> float:
    return max(((a.double() - b.double()).norm()
                / b.double().norm().clamp_min(1e-30)).item()
               for a, b in zip(got, want))


# The overlapped exchange's gradients against the monolithic one's: the
# same f32 terms summed across 4 ranks in another order (NCCL's order for
# an element depends on its place in the bucket), a few ulps each.
DP_OVERLAP_TOL = 1e-5


def dp_overlap(hvd, smi):
    """dp_cards_overlap: ResNet-50 with bn_axis="dp", fused convs, at
    batch 128 a card, HVDT_OVERLAP=on with 8 MiB buckets: state identical
    on every rank after 3 graphed steps; one step's exchanged gradients
    against the monolithic exchange's from the same state (relative L2);
    the graphed step with and without overlap in turns, and
    overlap_fraction."""
    import torch.distributed as dist

    from horovod_tpu_torch.models import ResNetConfig, resnet50_init
    from horovod_tpu_torch.ops import overlap
    from horovod_tpu_torch.step_pipeline import donated_step

    r, n = dist.get_rank(), dist.get_world_size()
    t0 = time.perf_counter()
    os.environ["HVDT_FUSION_THRESHOLD"] = str(OVERLAP_THRESHOLD)
    batch = _bf16_batch(500 + r, DP_TIME_BATCH)
    try:
        grads = {}
        for on in (False, True):
            _overlap_env(on)
            model = resnet50_init(0, ResNetConfig(bn_axis="dp"))
            hvd.broadcast_parameters(model.state_dict(), root_rank=0)
            opt = hvd.DistributedOptimizer(
                hvd.fused_sgd(model.parameters(), 0.01, momentum=0.9))
            grads[on] = _exchanged_grads(hvd, model, opt, *batch)
            _drop(opt)
            del model, opt
            _free()
        rel = _max_rel_l2(grads[True], grads[False])
        assert rel <= DP_OVERLAP_TOL, rel
        del grads
        overlap.reset_accounting()
        _overlap_env(True)
        om, oo, ostep, got = _dp_run(hvd, True, [batch], DP_STEPS,
                                     bn_axis="dp")
        same = _same_on_every_rank(
            [v for k, v in got.items() if k != "losses"])
        assert same
        fraction = overlap.overlap_fraction()
        buckets = len(oo._hooked.plan)
        kern = replay_kernels(lambda: ostep(om, oo, *batch))
        _overlap_env(False)
        model = resnet50_init(0, ResNetConfig(bn_axis="dp"))
        hvd.broadcast_parameters(model.state_dict(), root_rank=0)
        mo = hvd.DistributedOptimizer(
            hvd.fused_sgd(model.parameters(), 0.01, momentum=0.9))
        mstep = donated_step(_resnet_step)
        mstep(model, mo, *batch)
        times = {"monolithic": [], "overlapped": []}
        for name in ("monolithic", "overlapped", "overlapped",
                     "monolithic"):
            times[name].append(_graphed_ms(
                (lambda: mstep(model, mo, *batch)) if name == "monolithic"
                else (lambda: ostep(om, oo, *batch))))
        _drop(oo)
        del om, oo, ostep, model, mo, mstep
        _free()
    finally:
        _overlap_env(False)
        del os.environ["HVDT_FUSION_THRESHOLD"]
    if r == 0:
        emit({"phase": "dp_cards_overlap", "cards": n, "model": "resnet50",
              "batch_per_card": DP_TIME_BATCH, "bn_axis": "dp",
              "threshold_bytes": OVERLAP_THRESHOLD, "buckets": buckets,
              "state_identical_on_every_rank": same,
              "grads_rel_l2_vs_monolithic": rel,
              "tolerance": DP_OVERLAP_TOL, "overlap_fraction": fraction,
              "kernels_per_replay_rank0": kern, "step_ms": times,
              "wall_s": time.perf_counter() - t0, "card": smi})


# Adasum on the card (f32 combination, dots summed per shard, then across
# ranks) against the host tree in float64, relative L2 per bucket.
DP_ADASUM_TOL = 1e-5


def dp_adasum(hvd, smi):
    """dp_cards_adasum: one exchange of ResNet-50's gradients (batch 32 a
    card, bn_axis=None) under DistributedOptimizer(op=hvd.Adasum): each
    bucket's result against _np_adasum_tree over every rank's gathered
    gradients of that bucket."""
    import torch.distributed as dist

    from horovod_tpu_torch.models import ResNetConfig, resnet50_init
    from horovod_tpu_torch.ops.adasum import _np_adasum_tree

    r, n = dist.get_rank(), dist.get_world_size()
    t0 = time.perf_counter()
    images, labels = _bf16_batch(600 + r, DP_CHECK_BATCH)
    model = resnet50_init(0, ResNetConfig())
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    from horovod_tpu_torch.models import resnet_loss

    model.zero_grad(set_to_none=True)
    resnet_loss(model, images, labels)[0].backward()
    local = [p.grad.detach().clone() for p in model.parameters()]
    opt = hvd.DistributedOptimizer(
        hvd.fused_sgd(model.parameters(), 0.01), op=hvd.Adasum)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    opt.synchronize()
    torch.cuda.synchronize()
    exchange_ms = (time.perf_counter() - t1) * 1e3
    got = [p.grad.detach() for p in model.parameters()]
    errs = []
    for bucket in hvd.device.fused_allreduce_buckets(local, None):
        mine = torch.cat([local[i].reshape(-1) for i in bucket])
        every = mine.new_empty(n * mine.numel())
        dist.all_gather_into_tensor(every, mine)
        want = _np_adasum_tree(list(every.view(n, -1).double().cpu()
                                    .numpy()))
        mine_got = torch.cat([got[i].reshape(-1) for i in bucket])
        d = mine_got.double().cpu().numpy() - want
        errs.append({"elements": mine.numel(),
                     "rel_l2": float(np.linalg.norm(d)
                                     / np.linalg.norm(want)),
                     "max_abs_err": float(np.abs(d).max()),
                     "max_abs_want": float(np.abs(want).max())})
    assert all(e["rel_l2"] <= DP_ADASUM_TOL for e in errs), errs
    same = _same_on_every_rank(got)
    assert same
    del model, opt, local, got
    _free()
    if r == 0:
        emit({"phase": "dp_cards_adasum", "cards": n, "model": "resnet50",
              "batch_per_card": DP_CHECK_BATCH, "buckets": errs,
              "tolerance_rel_l2": DP_ADASUM_TOL,
              "identical_on_every_rank": same,
              "exchange_host_ms_rank0": exchange_ms,
              "wall_s": time.perf_counter() - t0, "card": smi})


# The hierarchical f32 exchange against the flat one: the same terms in
# another grouping (2 then 2 against NCCL's ring of 4).
DP_TRANSPORT_TOL = 1e-5


def dp_transport(hvd, smi):
    """dp_cards_transport, on a 2x2 ("dcn", "ici") mesh (both tiers are
    NVLink on one host): one exchange of ResNet-50's f32 gradients (batch
    32 a card) flat, hierarchical at f32 and with the int8 slow tier;
    each against flat (relative L2, and the int8 tier's error against
    its block-scale/2 bound); bytes a rank sends on each tier; each
    exchange's device ms."""
    import torch.distributed as dist

    from horovod_tpu_torch.models import ResNetConfig, resnet50_init
    from horovod_tpu_torch.models import resnet_loss
    from horovod_tpu_torch.parallel import make_mesh
    from horovod_tpu_torch.transport import hierarchy, policy

    r, n = dist.get_rank(), dist.get_world_size()
    t0 = time.perf_counter()
    mesh = make_mesh(dcn=2, ici=n // 2)
    images, labels = _bf16_batch(700 + r, DP_CHECK_BATCH)
    model = resnet50_init(0, ResNetConfig())
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    model.zero_grad(set_to_none=True)
    resnet_loss(model, images, labels)[0].backward()
    grads = [p.grad.detach().clone() for p in model.parameters()]
    del model
    specs = {"flat": None, "hier_f32": "ici:ring:f32,dcn:tree:f32",
             "hier_int8": "ici:ring:f32,dcn:tree:int8"}
    out, rows = {}, {}
    try:
        for name, spec in specs.items():
            if spec is None:
                os.environ.pop("HVDT_TRANSPORT", None)
            else:
                os.environ["HVDT_TRANSPORT"] = spec
            policy.reset()
            out[name] = hvd.device.fused_allreduce(grads)
            res = hvd.device.resolve_transport()[0]
            row = {"ms": _graphed_ms(
                lambda: hvd.device.fused_allreduce(grads), steps=5)}
            if res is not None and res.kind == "hierarchical":
                fast_n, slow_n = hierarchy.tier_sizes(res, mesh)
                fast_b = slow_b = 0
                for bucket in hvd.device.fused_allreduce_buckets(grads,
                                                                 None):
                    size = sum(grads[i].numel() for i in bucket)
                    total = hierarchy.wire_bytes_estimate(res, size, 4, mesh)
                    fb = 2 * hierarchy._ring_bytes(size, 4, fast_n)
                    fast_b += fb
                    slow_b += total - fb
                row.update({"tiers": [fast_n, slow_n],
                            "fast_tier_bytes_per_rank": fast_b,
                            "slow_tier_bytes_per_rank": slow_b})
            else:
                size = sum(g.numel() for g in grads)
                row["ring_bytes_per_rank"] = 2 * size * 4 * (n - 1) // n
            rows[name] = row
    finally:
        os.environ.pop("HVDT_TRANSPORT", None)
        policy.reset()
        hvd.common.basics.set_mesh(None)
    rows["hier_f32"]["rel_l2_vs_flat"] = _max_rel_l2(out["hier_f32"],
                                                     out["flat"])
    assert rows["hier_f32"]["rel_l2_vs_flat"] <= DP_TRANSPORT_TOL, rows
    # int8 slow tier: stage 1 quantizes each slow rank's ici sum, stage 2
    # the dcn sum; half a step of 1/127 of the block's absmax each, then
    # AVERAGE over n.  Taken here from the largest magnitudes.
    gmax = torch.tensor([max(g.abs().max().item() for g in grads)],
                        device=grads[0].device)
    dist.all_reduce(gmax, dist.ReduceOp.MAX)
    fast_max = (n // 2) * gmax.item()
    bound = (2 * fast_max / 127 / 2 + n * gmax.item() / 127 / 2) / n
    err = max((a - b).abs().max().item()
              for a, b in zip(out["hier_int8"], out["flat"]))
    rows["hier_int8"].update({"max_abs_err_vs_flat": err, "bound": bound,
                              "rel_l2_vs_flat": _max_rel_l2(
                                  out["hier_int8"], out["flat"])})
    assert err <= bound, (err, bound)
    same = _same_on_every_rank([t for v in out.values() for t in v])
    assert same
    del out, grads
    _free()
    if r == 0:
        emit({"phase": "dp_cards_transport", "cards": n,
              "mesh": {"dcn": 2, "ici": n // 2}, "model": "resnet50",
              "batch_per_card": DP_CHECK_BATCH, "exchanges": rows,
              "tolerance_rel_l2": DP_TRANSPORT_TOL,
              "identical_on_every_rank": same,
              "note": "both tiers are NVLink on one host",
              "wall_s": time.perf_counter() - t0, "card": smi})


DP_ZERO_TOL = 1e-5


def _more_steps(model, opt, step, batches):
    """Steps 2 to DP_STEPS of a run (the capture and the replays);
    returns their losses."""
    losses = [step(model, opt, *batches[0]).clone()
              for _ in range(DP_STEPS - 1)]
    torch.cuda.synchronize()
    return losses


def _params_moments_rel_l2(got: dict, want: dict) -> dict:
    """Relative L2 of the parameters and BN state, and of the moments,
    between two runs' states (f32 reassociation: ~1e-7)."""
    moments = [k for k in want if k[:2] in ("mu", "nu", "tr")]
    rest = [k for k in want if k not in moments and k != "losses"
            and want[k].is_floating_point()]
    return {"params_and_stats": _rel_l2([got[k] for k in rest],
                                        [want[k] for k in rest]),
            "moments": _rel_l2([got[k] for k in moments],
                               [want[k] for k in moments])}


def _int8_exchange_bound(gmax: float, leaf_quant: bool) -> float:
    """Largest error an element of the int8 reduce-scatter's mean can
    carry when no rank's gradient exceeds ``gmax`` in magnitude: stage 1
    quantizes each rank's bucket, stage 2 the reduced shard (|sum| <= n
    gmax), half a step of 1/127 of the block's absmax each, then the
    mean over n (the bound ``tests/test_torch_port_zero.py`` holds the
    CPU exchange to); error feedback's own quantization of each leaf
    (``leaf_quant``) adds half a step of gmax / 127.  Plus 1e-6 gmax for
    the f32 sums' order."""
    return gmax / 127 + (gmax / 254 if leaf_quant else 0.0) + gmax * 1e-6


def dp_zero(hvd, smi):
    """dp_cards_zero: ResNet-50 at batch 128 a card with bn_axis="dp" and
    fused convs, DistributedOptimizer(fused_adam(1e-3, weight_decay=
    1e-4)), graphed, 3 steps.  One exchange of the first step's
    gradients: rs_exchange against fused_allreduce in f32 (relative L2)
    and on the int8 wire (every element within the block-scale bound).
    Stages grads, states and params against the replicated step: the
    gradients' effect and the states after the first step (relative
    L2, asserted) and after 3 (relative L2, at most twice the same
    distance between two replicated runs at 64 MiB and 8 MiB buckets);
    the graphed run after 3 steps against the same stage run eagerly,
    bit for bit; the state identical on every rank; the optimizer
    state's bytes a rank (planned and by memory_allocated, against the
    replicated 204.5 MB); each stage's step ms against the replicated
    step's in turns.  States with the int8 wire under error feedback and
    HVDT_OVERLAP=on at 8 MiB buckets (the quantized reduce-scatter,
    #5/#6 and #1 a bucket a replay): its moments after the first step
    within the int8 bound of the replicated f32 run's.  A save of the
    4-shard state restored as 2 shards and as 4."""
    import shutil
    import tempfile

    import torch.distributed as dist

    from horovod_tpu_torch import checkpoint as ckpt
    from horovod_tpu_torch.models import (ResNetConfig, resnet50_init,
                                          resnet_loss)
    from horovod_tpu_torch.ops import zero as tz

    r, n = dist.get_rank(), dist.get_world_size()
    t0 = time.perf_counter()
    batch = [_bf16_batch(300 + r, DP_TIME_BATCH)]
    model = resnet50_init(0, ResNetConfig(bn_axis="dp"))
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    model.zero_grad(set_to_none=True)
    resnet_loss(model, *batch[0])[0].backward()
    grads = [p.grad.detach().clone() for p in model.parameters()]
    exact = hvd.device.fused_allreduce(grads)
    g_rel = _max_rel_l2(tz.rs_exchange(grads), exact)
    assert g_rel <= DP_ZERO_TOL, g_rel
    gmax_t = torch.tensor([max(g.abs().max().item() for g in grads)],
                          device=grads[0].device)
    dist.all_reduce(gmax_t, dist.ReduceOp.MAX)
    gmax = gmax_t.item()
    q_err = max((a - b).abs().max().item() for a, b in zip(
        tz.rs_exchange(grads,
                       wire_dtype=hvd.Compression.int8.wire_dtype), exact))
    q_bound = _int8_exchange_bound(gmax, leaf_quant=False)
    assert q_err <= q_bound, (q_err, q_bound)
    del model, grads, exact
    _free()

    # States are held to the replicated run's after one (eager) step.
    # After 3 steps bf16 compute on ill-conditioned gradients amplifies
    # the exchange's f32 reassociation (DP_CHECK_BATCH's note): the
    # control below measures how far it carries two replicated runs
    # that differ only in their buckets, and each stage is held to
    # twice that.
    rm, ro, rs_, want = _zero_run(hvd, "adam", None, batch, 1, bn_axis="dp")
    want3 = _zero_state_of(rm, ro, _more_steps(rm, ro, rs_, batch))
    repl_bytes = ro.hvdt_alloc_bytes
    os.environ["HVDT_FUSION_THRESHOLD"] = str(OVERLAP_THRESHOLD)
    try:
        cm, co, cs_, c1 = _zero_run(hvd, "adam", None, batch, 1,
                                    bn_axis="dp")
        c3 = _zero_state_of(cm, co, _more_steps(cm, co, cs_, batch))
    finally:
        del os.environ["HVDT_FUSION_THRESHOLD"]
    control = {"threshold_bytes": [64 << 20, OVERLAP_THRESHOLD],
               "rel_l2_after_one_step": _params_moments_rel_l2(c1, want),
               "rel_l2_after_steps": _params_moments_rel_l2(c3, want3)}
    del cm, co, cs_, c1, c3
    _free()
    rows = {}
    for stage in ("grads", "states", "params"):
        reset_counters()
        zm, zo, zs_, got1 = _zero_run(hvd, "adam", stage, batch, 1,
                                      bn_axis="dp")
        rel = _params_moments_rel_l2(got1, want)
        assert max(rel.values()) <= DP_ZERO_TOL, (stage, rel)
        got = _zero_state_of(zm, zo, _more_steps(zm, zo, zs_, batch))
        launches = counters()
        # The eager step and the capture; replays do not count.
        assert launches["_adam_kernel"] >= 2, (stage, launches)
        same = _same_on_every_rank([v for k, v in got.items()
                                    if k != "losses"])
        assert same, stage
        # The same stage eagerly: the same collectives in the same order,
        # so every byte agrees after DP_STEPS.
        em, eo, _, eager = _zero_run(hvd, "adam", stage, batch, DP_STEPS,
                                     graphed=False, bn_axis="dp")
        del em, eo
        _free()
        eager["losses"] = eager["losses"][1:]
        vs_eager = _state_err(got, eager)
        assert max(vs_eager.values()) == 0.0, (stage, vs_eager)
        del eager
        kern = replay_kernels(lambda: zs_(zm, zo, *batch[0]))
        assert kern["_adam_kernel"] == 1, (stage, kern)
        ms = {"replicated": [], "zero": []}
        for name in ("zero", "replicated", "replicated", "zero"):
            ms[name].append(_graphed_ms(
                (lambda: rs_(rm, ro, *batch[0])) if name == "replicated"
                else (lambda: zs_(zm, zo, *batch[0])), steps=5))
        rel3 = _params_moments_rel_l2(got, want3)
        # No further from the replicated run than twice the distance
        # another bucket size alone puts between two replicated runs.
        assert all(rel3[k] <= 2 * control["rel_l2_after_steps"][k]
                   + DP_ZERO_TOL for k in rel3), (stage, rel3, control)
        row = {"rel_l2_vs_replicated_after_one_step": rel,
               "rel_l2_vs_replicated_after_steps": rel3,
               "graphed_vs_eager_max_abs_err_after_steps": vs_eager,
               "identical_on_every_rank": same,
               "launches": {k: v for k, v in launches.items() if v},
               "kernels_per_replay": kern, "step_ms": ms,
               "optimizer_alloc_bytes": zo.hvdt_alloc_bytes}
        if stage != "grads":
            plan = zo.transform.plan_for(zo._zparams)
            planned = zo.transform.state_bytes_per_rank(zo._zparams)
            pad = 2 * len(plan.buckets) * tz.shard_align() * 4
            moments = 2 * sum(p.numel() * p.element_size()
                              for p in zo._zparams)
            assert planned <= moments // n + pad, (planned, moments)
            # Under "params" the optimizer also holds the parameter rows.
            rows_bytes = sum(t.numel() * t.element_size()
                             for t in zo.pshards or ())
            assert zo.hvdt_alloc_bytes - rows_bytes <= (
                repl_bytes // n + pad + (1 << 20)), (
                zo.hvdt_alloc_bytes, rows_bytes, repl_bytes)
            row.update({"planned_state_bytes_per_rank": planned,
                        "param_row_bytes": rows_bytes,
                        "replicated_moment_bytes": moments,
                        "buckets": len(plan.buckets),
                        "alignment_padding_bound": pad})
        if stage == "states":
            full = zo.gathered_zero_state()
            meta = zo.zero_metadata()
            path = hvd.broadcast_object(
                tempfile.mkdtemp(prefix="chip-smoke-zero-") if r == 0
                else None, root_rank=0)
            ckpt.save_zero_state(path, full, meta, step=DP_STEPS)
            as4, meta4, _ = ckpt.restore_zero_state(path)
            own = all(torch.equal(a[r].to(b.device), b[0]) for a, b in
                      zip(as4.mu + as4.nu,
                          zo.zero_state.mu + zo.zero_state.nu))
            as2, meta2, _ = ckpt.restore_zero_state(path, num_shards=2)
            f4 = tz.flatten_state_buffers(as4, meta4)
            f2 = tz.flatten_state_buffers(as2, meta2)
            resharded = all(np.array_equal(f4[k], f2[k]) for k in f4)
            assert own and resharded and meta2["num_shards"] == 2
            dist.barrier()
            if r == 0:
                zbytes = sum(os.path.getsize(os.path.join(path, f))
                             for f in os.listdir(path))
                shutil.rmtree(path, ignore_errors=True)
                row["checkpoint"] = {"saved_shards": n, "bytes": zbytes,
                                     "restored_as_4_own_rows": own,
                                     "restored_as_2_same_vector": resharded}
            del full, as4, as2
        rows[stage] = row
        del zm, zo, zs_, got
        _free()

    # The int8 wire under error feedback, overlapped, at 8 MiB buckets.
    os.environ["HVDT_FUSION_THRESHOLD"] = str(OVERLAP_THRESHOLD)
    _overlap_env(True)
    try:
        qm, qo, qs_, qgot1 = _zero_run(hvd, "adam", "states", batch, 1,
                                       bn_axis="dp", wire="int8")
        q_rel = _params_moments_rel_l2(qgot1, want)
        # After one step mu = (1 - b1) g and nu = (1 - b2) g^2 of the
        # exchanged mean gradient g: each element within the int8 bound.
        hp = _zero_inner(qo).optimizer.param_groups[0]
        e = _int8_exchange_bound(gmax, leaf_quant=True)
        m_bound = (1 - hp["b1"]) * e
        v_bound = (1 - hp["b2"]) * e * (2 * gmax + e)
        m_err = max((qgot1[k] - want[k]).abs().max().item()
                    for k in want if k.startswith("mu"))
        v_err = max((qgot1[k] - want[k]).abs().max().item()
                    for k in want if k.startswith("nu"))
        assert m_err <= m_bound and v_err <= v_bound, (
            m_err, m_bound, v_err, v_bound)
        qgot = _zero_state_of(qm, qo, _more_steps(qm, qo, qs_, batch))
        dopt = _zero_inner(qo)
        nb = len(dopt._hooked.plan)
        leaves = len(dopt._zparams)
        kern = replay_kernels(lambda: qs_(qm, qo, *batch[0]))
        # Error feedback quantizes and dequantizes every leaf; the
        # reduce-scatter quantizes each bucket once (its int8 accumulate
        # runs in PyTorch, not in #6); #1 runs once a bucket.
        want_k = (leaves + nb, leaves, nb)
        got_k = (kern["_quant_kernel"], kern["_dequant_kernel"],
                 kern["_adam_kernel"])
        assert got_k == want_k, (kern, want_k)
        same = _same_on_every_rank([v for k, v in qgot.items()
                                    if k != "losses"])
        assert same
        q_ms = _graphed_ms(lambda: qs_(qm, qo, *batch[0]), steps=5)
        _drop(qo)
        del qm, qo, qs_
        _free()
    finally:
        _overlap_env(False)
        del os.environ["HVDT_FUSION_THRESHOLD"]
    rows["states_int8_overlap"] = {
        "threshold_bytes": OVERLAP_THRESHOLD, "buckets": nb,
        "kernels_per_replay": kern,
        "expected_quant_dequant_adam_per_replay": list(want_k),
        "identical_on_every_rank": same,
        "rel_l2_vs_replicated_f32_after_one_step": q_rel,
        "moments_max_abs_err_after_one_step": {"mu": m_err, "nu": v_err},
        "moments_int8_bound": {"mu": m_bound, "nu": v_bound},
        "step_ms": q_ms}
    del rm, ro, rs_
    _free()
    if r == 0:
        emit({"phase": "dp_cards_zero", "cards": n, "model": "resnet50",
              "batch_per_card": DP_TIME_BATCH, "bn_axis": "dp",
              "optimizer": "fused_adam(1e-3, weight_decay=1e-4)",
              "steps": DP_STEPS, "grads_rel_l2_rs_vs_allreduce": g_rel,
              "grads_int8_rs_max_abs_err": q_err,
              "grads_int8_rs_bound": q_bound, "grads_max_abs": gmax,
              "replicated_optimizer_alloc_bytes": repl_bytes,
              "control_replicated_buckets": control,
              "stages": rows, "tolerance_rel_l2": DP_ZERO_TOL,
              "wall_s": time.perf_counter() - t0, "card": smi})


# The Queue 3 input (a gradient that only rank 0 has) on every exchange
# path, and the interop optimizer and SyncBatchNorm across the cards.
DP_MISSING_MODES = ("default", "k2", "overlap", "grads", "states", "params",
                    "grads_overlap", "states_overlap", "params_overlap",
                    "interop")
# The interop SyncBatchNorm's ragged per-rank batches against BatchNorm
# over the whole batch in f64 on the card: relative L2 of the outputs,
# the input gradients and the running statistics (f32 rounding).
DP_INTEROP_BN_TOL = 1e-5


def _missing_grad_run(hvd, mode, device):
    """Parameters a (4), b (3), c (5) of ones, SGD with lr 1, one step
    of ``mode`` (two passes under k2) on loss (r+1)·(sum a + sum c), plus
    10·sum b on rank 0 only.  Returns [a, b, c]."""
    import horovod_tpu_torch.interop.torch as ihvd

    r = hvd.rank()
    ps = [torch.ones(k, device=device, requires_grad=True)
          for k in (4, 3, 5)]
    stage = {"grads": "grads", "states": "states",
             "params": "params"}.get(mode.replace("_overlap", ""))
    _overlap_env(mode.endswith("overlap"))
    try:
        if mode == "interop":
            opt = ihvd.DistributedOptimizer(
                torch.optim.SGD(ps, lr=1.0),
                named_parameters=list(zip("abc", ps)))
        elif stage in ("states", "params"):
            opt = hvd.DistributedOptimizer(hvd.fused_sgd(ps, 1.0),
                                           zero=stage)
        else:
            opt = hvd.DistributedOptimizer(
                torch.optim.SGD(ps, lr=1.0), zero=stage,
                backward_passes_per_step=2 if mode == "k2" else 1)
        for _ in range(2 if mode == "k2" else 1):
            opt.zero_grad()
            a, b, c = ps
            loss = (r + 1) * (a.sum() + c.sum())
            if r == 0:
                loss = loss + 10 * b.sum()
            loss.backward()
            opt.step()
        if hasattr(opt, "gather_params"):
            opt.gather_params()
    finally:
        _overlap_env(False)
        if mode == "interop":
            opt._hvdt.remove()
        else:
            _drop(opt)
    return [p.detach() for p in ps]


def dp_missing_grad(hvd, smi, device="cuda"):
    """dp_cards_missing_grad: the Queue 3 input on every path over the
    process group (NCCL on the cards): a = c = 1 - (n+1)/2 and b =
    1 - 10/n on every rank, exactly."""
    import torch.distributed as dist

    r, n = dist.get_rank(), dist.get_world_size()
    t0 = time.perf_counter()
    want = [1.0 - (n + 1) / 2, 1.0 - 10.0 / n, 1.0 - (n + 1) / 2]
    rows = {}
    for mode in DP_MISSING_MODES:
        got = _missing_grad_run(hvd, mode, device)
        exact = all(torch.equal(g, torch.full_like(g, w))
                    for g, w in zip(got, want))
        ok = torch.tensor([int(exact)], device=got[0].device)
        dist.all_reduce(ok, dist.ReduceOp.MIN)
        rows[mode] = {"exact_on_every_rank": bool(ok.item()),
                      "rank0": [g.tolist() for g in got]}
        assert rows[mode]["exact_on_every_rank"], (mode, rows[mode], want)
    if r == 0:
        emit({"phase": "dp_cards_missing_grad", "cards": n,
              "expected_a_b_c": want, "modes": rows,
              "wall_s": time.perf_counter() - t0, "card": smi})


def dp_interop(hvd, smi):
    """dp_cards_interop: ResNet-50 (f32, unfused, bn_axis="dp", batch 32
    a card) under interop.torch.DistributedOptimizer(fused_sgd): its 161
    named allreduces on the eager controller over NCCL against one card
    running the global batch (dp_check's tolerance: twice what
    reordering the batch moves the gradients, plus 1e-3) and against the
    fused exchange of the same local gradients (DP_OVERLAP_TOL); the
    interop step (#2 once) leaves the parameters identical on every
    rank."""
    import torch.distributed as dist

    from horovod_tpu_torch.models import (ResNetConfig, resnet50_init,
                                          resnet_loss)

    r, n = dist.get_rank(), dist.get_world_size()
    t0 = time.perf_counter()
    images, labels = _bf16_batch(700 + r, DP_CHECK_BATCH)
    everyone = [torch.empty_like(images) for _ in range(n)]
    dist.all_gather(everyone, images)
    every_label = [torch.empty_like(labels) for _ in range(n)]
    dist.all_gather(every_label, labels)
    os.environ["HVDT_FUSED_CONV1X1"] = "0"
    try:
        model = resnet50_init(0, ResNetConfig(dtype=torch.float32,
                                              bn_axis="dp"))
        hvd.broadcast_parameters(model.state_dict(), root_rank=0)
        opt = _interop_opt(hvd, model)
        loss, _ = resnet_loss(model, images.float(), labels)
        loss.backward()                 # the hooks enqueue 161 allreduces
        local = [p.grad.detach().clone() for p in model.parameters()]
        torch.cuda.synchronize()
        t_sync = time.perf_counter()
        opt.synchronize()
        torch.cuda.synchronize()
        sync_ms = (time.perf_counter() - t_sync) * 1e3
        grads = [p.grad.detach().clone() for p in model.parameters()]
        fused = hvd.allreduce_gradients(local)
        vs_fused = _rel_l2(grads, fused)
        reset_counters()
        with opt.skip_synchronize():
            opt.step()
        torch.cuda.synchronize()
        launches = counters()
        same = _same_on_every_rank(list(model.parameters()))
        opt._hvdt.remove()
        del model, opt, local, fused
        _free()
    finally:
        os.environ["HVDT_FUSED_CONV1X1"] = "1"
    assert launches["_sgd_kernel"] == 1, launches
    assert same and vs_fused <= DP_OVERLAP_TOL, (same, vs_fused)
    if r:
        return
    want, want_g, floor = _global_f32_grads(torch.cat(everyone).float(),
                                            torch.cat(every_label))
    err = _rel_l2(grads, want_g)
    row = {"phase": "dp_cards_interop", "cards": n, "model": "resnet50",
           "batch_per_card": DP_CHECK_BATCH, "bn_axis": "dp",
           "named_allreduces": len(grads),
           "f32_grads_rel_l2_vs_global_batch": err,
           "f32_reordered_batch_grads_rel_l2": floor,
           "rel_l2_vs_fused_exchange": vs_fused,
           "tolerance": {"global_batch": "2 x reordered + 1e-3",
                         "fused_exchange": DP_OVERLAP_TOL},
           "synchronize_host_ms_rank0": sync_ms,
           "params_identical_on_every_rank": same,
           "launches_rank0": {k: v for k, v in launches.items() if v},
           "wall_s": time.perf_counter() - t0, "card": smi}
    assert err <= 2 * floor + 1e-3, row
    emit(row)


def dp_interop_sync_bn(hvd, smi, device="cuda"):
    """dp_cards_interop_sync_bn: the interop SyncBatchNorm with ragged
    per-rank batches (8, 10, ... rows of [C 64, 28, 28]) against
    BatchNorm over the whole batch in f64 on the card: each rank's
    outputs and input gradients of sum(y·w) and the running statistics
    within DP_INTEROP_BN_TOL (relative L2); a bf16 input keeps its
    dtype."""
    import torch.distributed as dist

    from horovod_tpu_torch.interop import torch_sync_batch_norm as tsbn

    r, n = dist.get_rank(), dist.get_world_size()
    t0 = time.perf_counter()
    rows = [8 + 2 * i for i in range(n)]
    lo = sum(rows[:r])
    g = torch.Generator(device=device).manual_seed(17)
    full = torch.randn((sum(rows), 64, 28, 28), generator=g, device=device)
    wgt = torch.randn(full.shape, generator=g, device=device)
    local = full[lo:lo + rows[r]].clone().requires_grad_()
    sbn = tsbn.SyncBatchNorm(64).to(device)
    y = sbn(local)
    (y * wgt[lo:lo + rows[r]]).sum().backward()
    ref = torch.nn.BatchNorm2d(64).to(device, torch.float64)
    x64 = full.double().requires_grad_()
    y64 = ref(x64)
    (y64 * wgt.double()).sum().backward()
    sl = slice(lo, lo + rows[r])
    errs = {"out": _rel_l2([y.detach()], [y64.detach()[sl]]),
            "dx": _rel_l2([local.grad], [x64.grad[sl]]),
            "running_mean": _rel_l2([sbn.running_mean],
                                    [ref.running_mean]),
            "running_var": _rel_l2([sbn.running_var], [ref.running_var])}
    xb = local.detach().to(torch.bfloat16).requires_grad_()
    yb = tsbn.SyncBatchNorm(64).to(device, torch.bfloat16)(xb)
    yb.float().sum().backward()
    kept = yb.dtype == torch.bfloat16 and xb.grad.dtype == torch.bfloat16
    worst = torch.tensor([max(errs.values())], device=full.device)
    dist.all_reduce(worst, dist.ReduceOp.MAX)
    assert worst.item() <= DP_INTEROP_BN_TOL and kept, (errs, kept)
    if r == 0:
        emit({"phase": "dp_cards_interop_sync_bn", "cards": n,
              "rows_per_rank": rows, "channels": 64, "spatial": [28, 28],
              "rel_l2_rank0": errs, "worst_rel_l2_any_rank": worst.item(),
              "tolerance": DP_INTEROP_BN_TOL, "bf16_dtype_kept": kept,
              "wall_s": time.perf_counter() - t0, "card": smi})


# bench_allreduce at 1, 4, 16 and 64 MiB: 5 timed calls of 5 chained
# operations after 2 warm-up calls, each mode in the dp world.
DP_BENCH_ARGS = ["--min-bytes", str(1 << 20), "--max-bytes", str(1 << 26),
                 "--iters", "5", "--inner", "5", "--warmup", "2"]
DP_BENCH_MODES = {"f32": ["--eager"], "bf16": ["--wire", "bf16"],
                  "fp16": ["--wire", "fp16"], "int8": ["--wire", "int8"],
                  "int4": ["--wire", "int4"],
                  "reduce_scatter": ["--reduce-scatter"], "a2a": ["--a2a"],
                  "hierarchical": ["--hierarchical"]}
# The per-size columns each mode's line keeps (the summary's rows).
DP_BENCH_COLUMNS = ("bytes", "axis", "algorithm", "wire", "us", "jit_us",
                    "jit_algbw_gbps", "jit_busbw_gbps", "bytes_on_wire",
                    "speedup_vs_f32", "eager_us", "allreduce_us",
                    "rs_ag_us", "rs_us", "rs_ag_speedup_vs_allreduce",
                    "a2a_us", "a2a_wire_bytes", "int8_speedup_vs_f32",
                    "hierarchical_speedup_vs_flat")


def dp_bench_allreduce(hvd, smi):
    """dp_cards_bench_allreduce: ``python -m
    horovod_tpu_torch.bench_allreduce``'s modes in this NCCL world
    (:data:`DP_BENCH_MODES` at the sizes of :data:`DP_BENCH_ARGS`): the
    flat sweep on every wire (f32 with the eager path; int8 / int4
    through #5-#8), --reduce-scatter (the ZeRO route), --a2a (the MoE
    all-to-all, exact and int8), --hierarchical (a 2 x 2 ("dcn", "ici")
    mesh under HVDT_TRANSPORT=auto).  One line a mode: the summary's
    verdict, its rows' columns, the kernels #5-#8 launched."""
    import contextlib
    import io

    import torch.distributed as dist

    from horovod_tpu_torch import bench_allreduce as ba
    from horovod_tpu_torch.common.basics import set_mesh
    from horovod_tpu_torch.transport import policy as tpolicy

    r = dist.get_rank()
    t0 = time.perf_counter()
    try:
        for mode, extra in DP_BENCH_MODES.items():
            args = ba.parse_args([*DP_BENCH_ARGS, *extra])
            reset_counters()
            sink = io.StringIO()
            with contextlib.redirect_stdout(sink), \
                    contextlib.redirect_stderr(sink):
                summary = ba.run(args)
            launches = counters()
            quant = {k: launches[k] for k in (
                "_quant_kernel", "_dequant_kernel", "_quant4_kernel",
                "_dequant4_kernel")}
            if mode in ("int8", "a2a"):
                assert quant["_quant_kernel"] > 0, (mode, quant)
                assert quant["_dequant_kernel"] > 0, (mode, quant)
            if mode == "int4":
                assert quant["_quant4_kernel"] > 0, (mode, quant)
                assert quant["_dequant4_kernel"] > 0, (mode, quant)
            assert all(math.isfinite(row["seconds"]) and row["seconds"] > 0
                       for row in summary["rows"]), summary
            if r == 0:
                emit({"phase": "dp_cards_bench_allreduce", "mode": mode,
                      "argv": [*DP_BENCH_ARGS, *extra],
                      **{k: v for k, v in summary.items() if k != "rows"},
                      "rows": [{k: row[k] for k in DP_BENCH_COLUMNS
                                if k in row} for row in summary["rows"]],
                      "quant_launches": quant, "card": smi})
    finally:
        os.environ.pop("HVDT_TRANSPORT", None)
        tpolicy.reset()
        set_mesh(None)
    if r == 0:
        emit({"phase": "dp_cards_bench_allreduce_total",
              "wall_s": time.perf_counter() - t0})


def dp_cards_worker(device=None) -> None:
    """One rank of ``--dp-cards``: :func:`dp_check`, :func:`dp_time`,
    :func:`dp_wire`, :func:`dp_vgg`, :func:`dp_accumulate`,
    :func:`dp_overlap`, :func:`dp_adasum`, :func:`dp_transport`,
    :func:`dp_zero`, :func:`dp_missing_grad`, :func:`dp_interop`,
    :func:`dp_interop_sync_bn` and :func:`dp_bench_allreduce` in an NCCL
    world of one process a card.  Rank 0 prints the lines.  The eager
    controller starts in dp_missing_grad's interop mode and the two
    interop phases (the interop optimizer and SyncBatchNorm negotiate by
    name); the bench_allreduce f32 sweep's eager path uses it too."""
    import torch.distributed as dist

    import horovod_tpu_torch as hvd

    hvd.init(device=device)
    smi = phase_device() if hvd.rank() == 0 else None
    os.environ["HVDT_FUSED_CONV1X1"] = "1"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    phases = (dp_check, dp_time, dp_wire, dp_vgg, dp_accumulate,
              dp_overlap, dp_adasum, dp_transport, dp_zero,
              dp_missing_grad, dp_interop, dp_interop_sync_bn,
              dp_bench_allreduce)
    try:
        for phase in phases:
            phase(hvd, smi)
            dist.barrier()
    except BaseException:
        # A failed rank leaves its peers blocked in a collective, and the
        # NCCL teardown at exit would wait on them: exit at once, so the
        # parent sees the failure and stops the others.
        import traceback

        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)
    hvd.shutdown()


def dp_cards(n: int) -> int:
    """``python3 chip_smoke.py --dp-cards N``: build the kernels, time the
    one-card bench leg G on card 0 (the yardstick of the scaling
    efficiency), then run :func:`dp_cards_worker` as N processes, one a
    card, in an NCCL world (rank 0 prints the lines).  A rank that fails
    stops them all."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        print(f"chip_smoke: --dp-cards {n} needs {n} CUDA cards",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from horovod_tpu_torch import bench

    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = phase_device()
    phase_build()
    leg, row = bench_leg(bench, "G", smi)
    emit({"phase": "bench_leg", **row})
    del leg
    gc.collect()
    torch.cuda.empty_cache()
    os.environ["CHIP_SMOKE_LEG_G_IMG_S"] = str(row["images_per_s"])
    rc = _spawn_ranks(n, "--dp-worker", DP_CARDS_TIMEOUT_S)
    if rc:
        return rc
    emit({"phase": "dp_cards_total", "wall_s": time.perf_counter() - t0})
    _last_lines(smi)
    return 0


# ---- python3 chip_smoke.py --parallel-cards 4: ep, pp and 4D across cards ---

PAR_CARDS = 4
PAR_CARDS_TIMEOUT_S = 900
PAR_EXPERTS, PAR_MOE_BATCH, PAR_PP_BATCH = 8, 32, 128
# bf16 runs against one card running the same global batch: the shapes
# of the products differ (a rank's tokens against all of them), so
# activations round differently and a router logit near a tie may pick
# another expert.  Loss within 1e-2 relative, each gradient within 5e-2
# relative L2 (the attention paths' bound in lm_bwd_default).
PAR_LOSS_TOL, PAR_GRAD_TOL = 1e-2, 5e-2
# The reference's 4D acceptance geometry (tests/test_parallel4d.py) at
# pp=2 x ep=2, f32: 5 SGD steps within rtol 2e-4 of the dense reference.
P4D_PP, P4D_EP, P4D_DIM, P4D_MB, P4D_TOK = 2, 2, 128, 4, 8
P4D_LR, P4D_STEPS, P4D_RTOL = 0.1, 5, 2e-4


def _world_mean(value) -> float:
    import torch.distributed as dist

    t = torch.tensor([float(value)], dtype=torch.float64, device="cuda")
    dist.all_reduce(t)
    return t.item() / dist.get_world_size()


def _moe_drops(model, tokens, cfg, **groups):
    """Each MoE layer's dropped fraction in one forward (no grad)."""
    from horovod_tpu_torch.models import transformer as tt

    drops, routed = [], tt._moe_mlp

    def record(*args, **kw):
        out, aux = routed(*args, **kw)
        drops.append(float(aux.dropped_fraction))
        return out, aux

    tt._moe_mlp = record
    try:
        with torch.no_grad():
            tt.transformer_loss(model, tokens, cfg, **groups)
    finally:
        tt._moe_mlp = routed
    return drops


def par_cards_moe(hvd, smi):
    """par_cards_moe: bert-large with ep = 4, 8 experts (2 a rank), seq
    512, batch 32 a rank, HVDT_FLASH_SMALLSEQ=on, DistributedOptimizer(
    fused_adam, axis="dp", expert="ep").  At capacity factor 8 (no drops)
    one step's loss and gradients against one card running the global
    batch with moe_dispatch_combine in a group of one (rank 0's experts
    and the replicated leaves); then 3 steps at 1.25: step ms, tokens/s a
    card, one all-to-all's ms and bytes a rank, the dropped fraction of
    each layer; par_cards_moe_int8: HVDT_TRANSPORT=ep:ring:int8:64M, its
    loss against the exact wire's at the same state (within 5%), 2 steps
    with #5 / #6 launches."""
    import dataclasses

    import torch.distributed as dist

    from horovod_tpu_torch.models import transformer as tt
    from horovod_tpu_torch.parallel import make_mesh, moe_capacity
    from horovod_tpu_torch.parallel import moe as tmoe

    r, n = dist.get_rank(), dist.get_world_size()
    t0 = time.perf_counter()
    mesh = make_mesh(dp=1, ep=n)
    one = dist.new_group([0])
    os.environ["HVDT_FLASH_SMALLSEQ"] = "on"
    cfg = dataclasses.replace(lm_config(SS_SEQ), num_experts=PAR_EXPERTS,
                              ep=n)
    check_cfg = dataclasses.replace(cfg, capacity_factor=float(PAR_EXPERTS))
    gen = torch.Generator(device="cuda").manual_seed(5)
    tokens = torch.randint(0, cfg.vocab, (n * PAR_MOE_BATCH, SS_SEQ),
                           generator=gen, device="cuda")
    mine = tokens[r * PAR_MOE_BATCH:(r + 1) * PAR_MOE_BATCH]
    model = tt.transformer_init(0, cfg, ep_rank=r)
    opt = hvd.DistributedOptimizer(
        hvd.fused_adam(model.parameters(), 3e-4, weight_decay=1e-4),
        axis="dp", expert="ep")
    loss = tt.transformer_loss(model, mine, check_cfg, ep_group=mesh)
    loss.backward()
    opt.synchronize()
    loss_ep = _world_mean(loss.detach())
    drops_check = _moe_drops(model, mine, check_cfg, ep_group=mesh)
    check = None
    if r == 0:
        got = {k: p.grad.detach().float() for k, p in
               model.named_parameters()}
        model.zero_grad(set_to_none=True)
        ref_cfg = dataclasses.replace(check_cfg, ep=1)
        ref = tt.transformer_init(0, ref_cfg)
        ref_loss = tt.transformer_loss(ref, tokens, ref_cfg, ep_group=one)
        ref_loss.backward()
        errs = {}
        for k, p in ref.named_parameters():
            want = p.grad.detach()
            if k.startswith("block."):
                want = tt.local_slice(k[6:], want, check_cfg, ep_rank=0)
            errs[k] = _rel_l2([got[k]], [want])
        check = {"capacity_factor": check_cfg.capacity_factor,
                 "dropped_fraction_max": max(drops_check),
                 "loss_ep": loss_ep, "loss_one_card": ref_loss.item(),
                 "loss_rel_err": abs(loss_ep - ref_loss.item())
                 / abs(ref_loss.item()),
                 "grad_rel_l2_rank0": errs,
                 "tolerances": [PAR_LOSS_TOL, PAR_GRAD_TOL]}
        del ref, ref_loss, got
        gc.collect()
        torch.cuda.empty_cache()
        assert max(drops_check) == 0.0, drops_check
        assert check["loss_rel_err"] <= PAR_LOSS_TOL, check
        assert max(errs.values()) <= PAR_GRAD_TOL, errs
    dist.barrier()
    model.zero_grad(set_to_none=True)

    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    times, losses = run_lm_steps(model, opt, mine, cfg, 3, ep_group=mesh)
    launches = counters()
    drops = _moe_drops(model, mine, cfg, ep_group=mesh)
    cap = moe_capacity(PAR_MOE_BATCH * SS_SEQ, PAR_EXPERTS, top_k=1,
                       capacity_factor=cfg.capacity_factor)
    block = torch.randn((n, PAR_EXPERTS // n, cap, cfg.d_model),
                        generator=gen, device="cuda").to(torch.bfloat16)
    ring = tmoe._Ring(mesh, "ep")
    a2a_ms = cuda_ms(lambda: tmoe._exchange(block, ring), iters=5, reps=3)
    a2a_bytes = tmoe.a2a_wire_bytes(block.shape, block.dtype, None)
    steady = sorted(times[1:])[len(times[1:]) // 2]
    assert all(math.isfinite(x) for x in losses), losses
    assert launches["_smallseq_fwd_kernel"] == 48 * 3, launches
    assert launches["_smallseq_bwd_kernel"] == 24 * 3, launches
    assert launches["_adam_kernel"] == 3, launches
    row = {"phase": "par_cards_moe", "cards": n, "model": "bert-large",
           "ep": n, "experts": PAR_EXPERTS, "seq": SS_SEQ,
           "batch_per_card": PAR_MOE_BATCH,
           "params_rank0": sum(p.numel() for p in model.parameters()),
           "check_vs_one_card": check, "capacity_factor":
           cfg.capacity_factor, "capacity": cap, "losses_rank0": losses,
           "step_s_rank0": times, "steady_step_s": steady,
           "tokens_per_s_per_card": PAR_MOE_BATCH * SS_SEQ / steady,
           "dropped_fraction_by_layer_rank0": drops,
           "a2a_ms": a2a_ms, "a2a_bytes_per_rank": a2a_bytes,
           "a2a_bytes_off_rank": a2a_bytes * (n - 1) // n,
           "a2a_per_layer_step": 6,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches_rank0": launches, "card": smi}
    del block

    # The int8 ep wire.
    with torch.no_grad():
        exact = _world_mean(tt.transformer_loss(model, mine, cfg,
                                                ep_group=mesh))
    os.environ["HVDT_TRANSPORT"] = "ep:ring:int8:64M"
    try:
        with torch.no_grad():
            quant = _world_mean(tt.transformer_loss(model, mine, cfg,
                                                    ep_group=mesh))
        reset_counters()
        q_times, q_losses = run_lm_steps(model, opt, mine, cfg, 2,
                                         ep_group=mesh)
        q_launches = counters()
    finally:
        del os.environ["HVDT_TRANSPORT"]
    int8_bytes = tmoe.a2a_wire_bytes((n, PAR_EXPERTS // n, cap, cfg.d_model),
                                     torch.bfloat16, "int8")
    assert abs(quant - exact) <= 0.05 * abs(exact), (quant, exact)
    assert q_launches["_quant_kernel"] == 24 * 6 * 2, q_launches
    assert q_launches["_dequant_kernel"] == 24 * 6 * 2, q_launches
    row["wall_s"] = time.perf_counter() - t0
    if r == 0:
        emit(row)
        emit({"phase": "par_cards_moe_int8", "cards": n,
              "loss_exact_wire": exact, "loss_int8_wire": quant,
              "rel_diff": abs(quant - exact) / abs(exact),
              "tolerance": 0.05, "step_s_rank0": q_times,
              "losses_rank0": q_losses,
              "a2a_bytes_per_rank": int8_bytes,
              "launches_rank0": {k: q_launches[k] for k in (
                  "_quant_kernel", "_dequant_kernel", "_smallseq_fwd_kernel",
                  "_smallseq_bwd_kernel", "_adam_kernel")},
              "card": smi})
    del model, opt, tokens, mine
    gc.collect()
    torch.cuda.empty_cache()


def par_cards_pp(hvd, smi):
    """par_cards_pp: bert-large (dense) with pp = 4, 6 layers a stage, m =
    4 microbatches, global batch 128 on every stage, HVDT_FLASH_SMALLSEQ=
    on, DistributedOptimizer(fused_adam, axis="dp", pipeline="pp"): one
    step's loss and gradients (every stage's, all-gathered) against one
    card running all 24 layers on the batch; 3 steps: step ms, #12 / #13
    launches; the priced bubble (p-1)/(m+p-1) against the observed one,
    1 - m * t_stage / t_pipe, from the pipeline's forward and backward
    (t_pipe) and one stage's on one microbatch without transfers
    (t_stage), the slowest rank's each."""
    import dataclasses

    import torch.distributed as dist

    from horovod_tpu_torch.models import transformer as tt
    from horovod_tpu_torch.parallel import (bubble_fraction, make_mesh,
                                            pipeline_1f1b)

    r, n = dist.get_rank(), dist.get_world_size()
    t0 = time.perf_counter()
    mesh = make_mesh(dp=1, pp=n)
    os.environ["HVDT_FLASH_SMALLSEQ"] = "on"
    cfg = dataclasses.replace(lm_config(SS_SEQ), pp=n)
    gen = torch.Generator(device="cuda").manual_seed(6)
    tokens = torch.randint(0, cfg.vocab, (PAR_PP_BATCH, SS_SEQ),
                           generator=gen, device="cuda")
    model = tt.transformer_init(0, cfg, pp_rank=r)
    opt = hvd.DistributedOptimizer(
        hvd.fused_adam(model.parameters(), 3e-4, weight_decay=1e-4),
        axis="dp", pipeline="pp")
    loss = tt.transformer_loss(model, tokens, cfg, pp_group=mesh)
    loss.backward()
    opt.synchronize()
    group = mesh.get_group("pp")
    got = {}
    for k, p in model.named_parameters():
        g = p.grad.detach().float().contiguous()
        if k.startswith("block."):
            full = g.new_empty((n * g.shape[0], *g.shape[1:]))
            dist.all_gather_into_tensor(full, g, group=group)
            g = full
        got[k] = g
    model.zero_grad(set_to_none=True)
    check = None
    if r == 0:
        ref = tt.transformer_init(0, lm_config(SS_SEQ))
        ref_loss = tt.transformer_loss(ref, tokens, lm_config(SS_SEQ))
        ref_loss.backward()
        errs = {k: _rel_l2([got[k]], [p.grad]) for k, p in
                ref.named_parameters()}
        check = {"loss_pp": loss.item(), "loss_one_card": ref_loss.item(),
                 "loss_rel_err": abs(loss.item() - ref_loss.item())
                 / abs(ref_loss.item()),
                 "grad_rel_l2": errs,
                 "tolerances": [PAR_LOSS_TOL, PAR_GRAD_TOL]}
        del ref, ref_loss
        assert check["loss_rel_err"] <= PAR_LOSS_TOL, check
        assert max(errs.values()) <= PAR_GRAD_TOL, errs
    del got
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()

    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    times, losses = run_lm_steps(model, opt, tokens, cfg, 3, pp_group=mesh)
    launches = counters()
    peak = torch.cuda.max_memory_allocated() / 1e9
    assert all(math.isfinite(x) for x in losses), losses
    per = cfg.layers_per_stage * n          # layers x microbatches
    assert launches["_smallseq_fwd_kernel"] == 2 * per * 3, launches
    assert launches["_smallseq_bwd_kernel"] == per * 3, launches

    # The bubble: the pipeline alone against one stage on one microbatch.
    mb = PAR_PP_BATCH // n
    acts = torch.randn((n, mb, SS_SEQ, cfg.d_model), generator=gen,
                       device="cuda").to(torch.bfloat16).requires_grad_()
    positions = torch.arange(SS_SEQ, device="cuda").expand(mb, SS_SEQ)
    blocks = dict(model.block)

    def stage_fn(p, a):
        return tt._scan_blocks(p, a, positions, cfg)

    def pipe():
        out = pipeline_1f1b(stage_fn, blocks, acts, group=mesh)
        out.float().square().mean().backward()

    def stage():
        stage_fn(blocks, acts[0]).float().square().mean().backward()

    def slowest(fn, reps=3):
        fn()
        best = math.inf
        for _ in range(reps):
            dist.barrier()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t1)
        t = torch.tensor([best], device="cuda")
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return t.item()

    t_pipe, t_stage = slowest(pipe), slowest(stage)
    model.zero_grad(set_to_none=True)
    observed = 1.0 - n * t_stage / t_pipe
    steady = sorted(times[1:])[len(times[1:]) // 2]
    if r == 0:
        emit({"phase": "par_cards_pp", "cards": n, "model": "bert-large",
              "pp": n, "layers_per_stage": cfg.layers_per_stage,
              "microbatches": n, "batch": PAR_PP_BATCH, "seq": SS_SEQ,
              "check_vs_one_card": check, "losses_rank0": losses,
              "step_s_rank0": times, "steady_step_s": steady,
              "tokens_per_s": PAR_PP_BATCH * SS_SEQ / steady,
              "bubble_fraction_priced": bubble_fraction(n, n),
              "bubble_fraction_observed": observed,
              "t_pipe_s": t_pipe, "t_stage_s": t_stage,
              "peak_mem_gb_rank0": peak, "launches_rank0": launches,
              "wall_s": time.perf_counter() - t0, "card": smi})
    del model, opt, tokens, acts, blocks
    gc.collect()
    torch.cuda.empty_cache()


def _p4d_dense_loss(p, x, tgt):
    """The battery's single-device reference: sequential stages, argmax
    top-1 routing (at top_k 1 the renormalised gate is 1)."""
    losses = []
    for mb in range(P4D_MB):
        h = x[mb]
        for s in range(P4D_PP):
            a = torch.tanh(h @ p["w"][s])
            sel = torch.argmax(a @ p["rw"][s], -1)
            outs = torch.stack([torch.tanh(a @ p["we"][s, e])
                                for e in range(P4D_EP)])
            h = h + outs.gather(0, sel[None, :, None].expand(
                1, -1, P4D_DIM))[0]
        losses.append(((h - tgt[mb]) ** 2).mean())
    return torch.stack(losses).mean()


def par_cards_4d(hvd, smi):
    """par_cards_4d: the reference's 4D acceptance geometry at pp=2 x
    ep=2 (f32): each stage an in-projection and an MoE layer over ep (one
    expert a rank, top-1, capacity factor 4), pipeline_1f1b over pp,
    DistributedOptimizer(SGD(0.1), axis="dp", pipeline="pp", expert=
    "ep"): 5 steps' losses and every rank's parameters against the dense
    one-card reference (rank 0) within rtol 2e-4."""
    import torch.distributed as dist

    from horovod_tpu_torch.parallel import (make_mesh, mark_sharded,
                                            moe_dispatch_combine,
                                            pipeline_1f1b)

    r = dist.get_rank()
    t0 = time.perf_counter()
    mesh = make_mesh(dp=1, pp=P4D_PP, ep=P4D_EP)
    s, e = mesh.get_local_rank("pp"), mesh.get_local_rank("ep")
    gen = torch.Generator(device="cuda").manual_seed(42)
    scale = 0.5 / math.sqrt(P4D_DIM)
    full = {"w": torch.randn((P4D_PP, P4D_DIM, P4D_DIM), generator=gen,
                             device="cuda") * scale,
            "rw": torch.randn((P4D_PP, P4D_DIM, P4D_EP), generator=gen,
                              device="cuda"),
            "we": torch.randn((P4D_PP, P4D_EP, P4D_DIM, P4D_DIM),
                              generator=gen, device="cuda") * scale}
    x = torch.randn((P4D_MB, P4D_EP * P4D_TOK, P4D_DIM), generator=gen,
                    device="cuda")
    tgt = torch.randn((P4D_MB, P4D_EP * P4D_TOK, P4D_DIM), generator=gen,
                      device="cuda") * 0.1
    mine = [mark_sharded(full["w"][s].clone().requires_grad_(), "pp"),
            mark_sharded(full["rw"][s].clone().requires_grad_(), "pp"),
            mark_sharded(full["we"][s, e].clone().requires_grad_(), "pp",
                         "ep")]
    rows = slice(e * P4D_TOK, (e + 1) * P4D_TOK)

    def stage_fn(p, h_in):
        h = torch.tanh(h_in @ p[0])
        y, _ = moe_dispatch_combine(
            h, h @ p[1],
            lambda blk: torch.tanh(torch.einsum("ecd,df->ecf", blk, p[2])),
            group=mesh, experts_per_rank=1, capacity_factor=4.0, top_k=1)
        return h_in + y

    opt = hvd.DistributedOptimizer(torch.optim.SGD(mine, lr=P4D_LR),
                                   axis="dp", pipeline="pp", expert="ep")
    losses = []
    for _ in range(P4D_STEPS):
        opt.zero_grad()
        out = pipeline_1f1b(stage_fn, mine, x[:, rows], group=mesh)
        loss = ((out - tgt[:, rows]) ** 2).mean()
        loss.backward()
        opt.step()
        losses.append(_world_mean(loss.detach()))
    ref = {k: v.clone() for k, v in full.items()}
    ref_losses = []
    if r == 0:
        for _ in range(P4D_STEPS):
            p = {k: v.clone().requires_grad_() for k, v in ref.items()}
            loss = _p4d_dense_loss(p, x, tgt)
            loss.backward()
            ref_losses.append(loss.item())
            # The router gets no gradient through argmax: zero, as
            # jax.grad gives it.
            ref = {k: (p[k] - P4D_LR * p[k].grad).detach()
                   if p[k].grad is not None else p[k].detach() for k in p}
    for v in ref.values():
        dist.broadcast(v, 0)
    want = [ref["w"][s], ref["rw"][s], ref["we"][s, e]]
    param_err = max(((m.detach() - w).abs()
                     / (P4D_RTOL * w.abs() + 1e-6)).max().item()
                    for m, w in zip(mine, want))
    worst = torch.tensor([param_err], device="cuda")
    dist.all_reduce(worst, op=dist.ReduceOp.MAX)
    if r == 0:
        loss_err = max(abs(a - b) / (P4D_RTOL * abs(b) + 1e-6)
                       for a, b in zip(losses, ref_losses))
        emit({"phase": "par_cards_4d", "cards": dist.get_world_size(),
              "pp": P4D_PP, "ep": P4D_EP, "dim": P4D_DIM, "steps": P4D_STEPS,
              "losses": losses, "reference_losses": ref_losses,
              "loss_err_over_tol": loss_err,
              "param_err_over_tol_all_ranks": worst.item(),
              "rtol": P4D_RTOL, "atol": 1e-6,
              "wall_s": time.perf_counter() - t0, "card": smi})
        assert loss_err <= 1.0 and losses[-1] < losses[0], (losses,
                                                            ref_losses)
    assert worst.item() <= 1.0, worst.item()


def par_cards_sweeps(hvd, smi):
    """The bench's --moe and --pipeline sweeps over the 4-card world (as
    ep, then as pp): their JSON, and each autotune seed reader on the
    file the sweep wrote."""
    import tempfile

    import torch.distributed as dist

    from horovod_tpu_torch import autotune, bench

    r = dist.get_rank()
    root = tempfile.mkdtemp(prefix="hvdt-par-sweeps-")
    for flag, run, key, reader, knob in (
            ("--moe", bench.run_moe_bench, "capacity_factor_at_peak",
             autotune._env_capacity_factor, "HVDT_AUTOTUNE_MOE_SEED"),
            ("--pipeline", bench.run_pipeline_bench, "microbatches_at_peak",
             autotune._env_microbatches, "HVDT_AUTOTUNE_PIPELINE_SEED")):
        path = os.path.join(root, f"{flag[2:]}{r}.json")
        t0 = time.perf_counter()
        doc = run(bench._parse_args([flag, "--json-out", path]))
        os.environ[knob] = path
        try:
            seeded = reader()
        finally:
            del os.environ[knob]
        assert seeded == doc[key], (seeded, doc[key])
        if r == 0:
            emit({"phase": f"par_cards_{flag[2:]}_sweep", **doc,
                  "autotune_seed": {knob: seeded},
                  "wall_s": time.perf_counter() - t0, "card": smi})
        dist.barrier()


# ---- tp, fsdp and the sequence axis beside dp / pp across cards -----------

PAR_TP_BATCH = 32              # the same rows on every tp member
PAR_FSDP_BATCH = 32            # a card's rows (global 128)
PAR_DPTP_BATCH = 32            # a dp member's rows (global 64)
PAR_SPDP_SEQ, PAR_SPDP_BATCH = 4096, 4   # global seq; a dp member's rows
PAR_SPPP_BATCH = 32            # every stage's rows (2 microbatches)
PAR_TPEP_BATCH = 32            # an ep member's rows (global 64)
PAR_PHASE_TIMEOUT_S = 300


class _PhaseTimeout:
    """A watchdog for one four-card phase: if the phase outlives
    ``seconds`` (a collective issued in another order on another rank
    hangs in NCCL, where no Python signal reaches), it names the phase
    on stderr and ends this rank, so the parent stops the others."""

    def __init__(self, name: str, seconds: float = PAR_PHASE_TIMEOUT_S):
        import threading

        self.name, self.seconds = name, seconds
        self.done = threading.Event()
        self.thread = threading.Thread(target=self._watch, daemon=True)

    def _watch(self):
        if not self.done.wait(self.seconds):
            print(f"chip_smoke: phase {self.name} timed out after "
                  f"{self.seconds} s", file=sys.stderr, flush=True)
            os._exit(1)

    def __enter__(self):
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.done.set()


class _CollectiveCount:
    """Counts the all-reduces and all-gathers issued on ``group`` while
    active, with the bytes of each (torch.distributed is patched)."""

    def __init__(self, group):
        self.group, self.calls = group, {"all_reduce": [],
                                         "all_gather_into_tensor": []}

    def __enter__(self):
        import torch.distributed as dist

        self.saved = {}
        for name in self.calls:
            orig = getattr(dist, name)
            self.saved[name] = orig

            def wrap(*args, _orig=orig, _name=name, **kw):
                if kw.get("group") is self.group:
                    t = args[0] if _name == "all_reduce" else args[1]
                    self.calls[_name].append(t.numel() * t.element_size())
                return _orig(*args, **kw)

            setattr(dist, name, wrap)
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist

        for name, orig in self.saved.items():
            setattr(dist, name, orig)


def _whole_grads(model, cfg, mesh, grads: bool = True):
    """Every leaf's gradient (or, with ``grads=False``, its value)
    gathered whole over the mesh axes its spec shards it on, in f32
    (collective: every rank calls it)."""
    import torch.distributed as dist

    from horovod_tpu_torch.models import transformer as tt

    out = {}
    for name, p in model.named_parameters():
        g = (p.grad if grads else p).detach().float().contiguous()
        for dim, entry in enumerate(tt.leaf_spec(name.split(".")[-1], cfg)):
            for axis in ((entry,) if isinstance(entry, str) else entry or ()):
                group = mesh.get_group(axis)
                parts = [torch.empty_like(g)
                         for _ in range(dist.get_world_size(group))]
                dist.all_gather(parts, g, group=group)
                g = torch.cat(parts, dim)
        out[name] = g
    return out


def _replicated_equal(model) -> bool:
    """Whether every leaf sharded over no axis holds the same gradient,
    bit for bit, on every rank (rank 0's broadcast against each)."""
    import torch.distributed as dist

    from horovod_tpu_torch.parallel import sharded_axes

    ok = True
    for p in model.parameters():
        if sharded_axes(p):
            continue
        mine = p.grad.detach()
        theirs = mine.clone()
        dist.broadcast(theirs, 0)
        ok = ok and torch.equal(mine, theirs)
    flag = torch.tensor([int(ok)], device="cuda")
    dist.all_reduce(flag, op=dist.ReduceOp.MIN)
    return bool(flag.item())


def _sp_loss_one_card(model, tokens, cfg, sp):
    """The mean of the sp members' local losses on one card: the whole
    sequence's hidden states, then each shard's chunked loss (a shard's
    last position has no target)."""
    from horovod_tpu_torch.models import transformer as tt

    x = tt.transformer_hidden(model, tokens, cfg)
    n = tokens.shape[1] // sp
    return sum(tt._chunked_xent(x[:, s * n:(s + 1) * n - 1], model.embed,
                                tokens[:, s * n + 1:(s + 1) * n],
                                cfg.loss_chunk) for s in range(sp)) / sp


def _check_one_card(name, loss_mean, got, ref_cfg, ref_tokens, sp=1):
    """Rank 0: one card runs the whole model on ``ref_tokens`` (the
    same seed); the members' mean loss and the gathered gradients
    against it.  Returns the check's dict."""
    from horovod_tpu_torch.models import transformer as tt

    ref = tt.transformer_init(0, ref_cfg)
    ref_loss = (tt.transformer_loss(ref, ref_tokens, ref_cfg) if sp == 1
                else _sp_loss_one_card(ref, ref_tokens, ref_cfg, sp))
    ref_loss.backward()
    errs = {k: _rel_l2([got[k]], [p.grad]) for k, p in
            ref.named_parameters()}
    check = {"loss_members": loss_mean, "loss_one_card": ref_loss.item(),
             "loss_rel_err": abs(loss_mean - ref_loss.item())
             / abs(ref_loss.item()),
             "grad_rel_l2": errs, "grad_rel_l2_max": max(errs.values()),
             "tolerances": [PAR_LOSS_TOL, PAR_GRAD_TOL]}
    del ref, ref_loss
    gc.collect()
    torch.cuda.empty_cache()
    assert check["loss_rel_err"] <= PAR_LOSS_TOL, (name, check)
    assert max(errs.values()) <= PAR_GRAD_TOL, (name, errs)
    return check


def _steady(times):
    return sorted(times[1:])[len(times[1:]) // 2]


def _lm_tokens(seed, batch, seq, vocab):
    """The same [batch, seq] tokens on every rank."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randint(0, vocab, (batch, seq), generator=gen,
                         device="cuda")


def _lm_step(model, opt, tokens, cfg, **groups):
    from horovod_tpu_torch.models import transformer_loss

    opt.zero_grad()
    transformer_loss(model, tokens, cfg, **groups).backward()
    opt.step()


def _one_card_step(batch: int) -> dict:
    """Rank 0 alone: the dense bert-large step at seq 512 on ``batch``
    rows with fused_adam, 3 host-timed steps and a 2-step profile: the
    yardstick of the tp and fsdp steps."""
    from horovod_tpu_torch import fused_adam
    from horovod_tpu_torch.models import transformer as tt

    cfg = lm_config(SS_SEQ)
    model = tt.transformer_init(0, cfg)
    opt = fused_adam(model.parameters(), 3e-4, weight_decay=1e-4)
    tokens = _lm_tokens(12, batch, SS_SEQ, cfg.vocab)
    times, _ = run_lm_steps(model, opt, tokens, cfg, 3)
    profile, _ = step_profile(lambda: _lm_step(model, opt, tokens, cfg),
                              steps=2)
    del model, opt
    gc.collect()
    torch.cuda.empty_cache()
    return {"batch": batch, "step_s": times, "steady_step_s": _steady(times),
            "profile": profile}


def par_cards_tp(hvd, smi):
    """par_cards_tp: bert-large with tp = 4 (4 of 16 heads and 1024 of
    4096 MLP columns a card), seq 512, the same batch of 32 on every
    card, HVDT_FLASH_SMALLSEQ=on (#12/#13 on the 4 local heads),
    DistributedOptimizer(fused_adam, axis="dp"): one step's loss and
    gradients (gathered over tp) against one card running the whole
    model on the batch, every replicated leaf's gradient equal on every
    card; then 3 steps: step seconds, tokens/s, the tp all-reduces and
    all-gathers a step with the bytes and device ms of one, launches, a
    2-step profile (device ms by kernel class), and rank 0's dense step
    on the same 32 rows (3 steps and a profile) as the yardstick."""
    import dataclasses

    import torch.distributed as dist

    from horovod_tpu_torch.models import transformer as tt
    from horovod_tpu_torch.parallel import make_mesh

    r, n = dist.get_rank(), dist.get_world_size()
    t0 = time.perf_counter()
    mesh = make_mesh(dp=1, tp=n)
    os.environ["HVDT_FLASH_SMALLSEQ"] = "on"
    cfg = dataclasses.replace(lm_config(SS_SEQ), tp=n)
    tokens = _lm_tokens(7, PAR_TP_BATCH, SS_SEQ, cfg.vocab)
    model = tt.transformer_init(0, cfg, tp_rank=r)
    opt = hvd.DistributedOptimizer(
        hvd.fused_adam(model.parameters(), 3e-4, weight_decay=1e-4),
        axis="dp")
    loss = tt.transformer_loss(model, tokens, cfg, tp_group=mesh)
    loss.backward()
    opt.synchronize()
    replicated_equal = _replicated_equal(model)
    got = _whole_grads(model, cfg, mesh)
    check = (_check_one_card("par_cards_tp", loss.item(), got,
                             lm_config(SS_SEQ), tokens)
             if r == 0 else None)
    del got
    model.zero_grad(set_to_none=True)
    dist.barrier()
    assert replicated_equal

    group = mesh.get_group("tp")
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    with _CollectiveCount(group) as calls:
        times, losses = run_lm_steps(model, opt, tokens, cfg, 3,
                                     tp_group=mesh)
    launches = counters()
    profile_tp, _ = step_profile(lambda: _lm_step(model, opt, tokens, cfg,
                                                  tp_group=mesh), steps=2)
    act = torch.randn((PAR_TP_BATCH, SS_SEQ, cfg.d_model), device="cuda",
                      dtype=cfg.dtype)
    ar_ms = cuda_ms(lambda: dist.all_reduce(act, group=group), iters=10,
                    reps=3)
    assert all(math.isfinite(x) for x in losses), losses
    assert launches["_smallseq_fwd_kernel"] == 48 * 3, launches
    assert launches["_smallseq_bwd_kernel"] == 24 * 3, launches
    assert launches["_adam_kernel"] == 3, launches
    ar, ag = calls.calls["all_reduce"], calls.calls["all_gather_into_tensor"]
    if r == 0:
        one_card = _one_card_step(PAR_TP_BATCH)
        steady = _steady(times)
        emit({"phase": "par_cards_tp", "cards": n, "model": "bert-large",
              "tp": n, "local_heads": cfg.heads // n, "seq": SS_SEQ,
              "batch": PAR_TP_BATCH, "check_vs_one_card": check,
              "replicated_grads_equal_on_every_card": replicated_equal,
              "params_rank0": sum(p.numel() for p in model.parameters()),
              "losses_rank0": losses, "step_s_rank0": times,
              "steady_step_s": steady,
              "tokens_per_s": PAR_TP_BATCH * SS_SEQ / steady,
              "tp_all_reduce_per_step": len(ar) / 3,
              "tp_all_reduce_bytes": sorted(set(ar)),
              "tp_all_reduce_ms": ar_ms,
              "tp_all_reduce_bytes_timed": act.numel() * act.element_size(),
              "tp_all_gather_per_step": len(ag) / 3,
              "tp_all_gather_bytes": sorted(set(ag)),
              "peak_mem_gb_rank0": torch.cuda.max_memory_allocated() / 1e9,
              "launches_rank0": launches, "profile_tp_rank0": profile_tp,
              "one_card_same_batch": one_card,
              "wall_s": time.perf_counter() - t0, "card": smi})
    del model, opt, tokens, act
    gc.collect()
    torch.cuda.empty_cache()


def par_cards_fsdp(hvd, smi):
    """par_cards_fsdp: bert-large with fsdp = 4 (every embed dimension a
    quarter a card, each block's leaves gathered in the block and again
    in its remat recompute), seq 512, batch 32 a card,
    HVDT_FLASH_SMALLSEQ=on, DistributedOptimizer(fused_adam, axis="dp"):
    one step's loss (the cards' mean) and gradients (gathered over fsdp)
    against one card running the global batch of 128; parameter and
    optimizer-state bytes a card against replicated, peak memory; 3
    steps."""
    import dataclasses

    import torch.distributed as dist

    from horovod_tpu_torch.models import transformer as tt
    from horovod_tpu_torch.parallel import make_mesh

    r, n = dist.get_rank(), dist.get_world_size()
    t0 = time.perf_counter()
    mesh = make_mesh(dp=1, fsdp=n)
    os.environ["HVDT_FLASH_SMALLSEQ"] = "on"
    cfg = dataclasses.replace(lm_config(SS_SEQ), fsdp=n)
    tokens = _lm_tokens(8, n * PAR_FSDP_BATCH, SS_SEQ, cfg.vocab)
    mine = tokens[r * PAR_FSDP_BATCH:(r + 1) * PAR_FSDP_BATCH]
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    model = tt.transformer_init(0, cfg, fsdp_rank=r)
    opt = hvd.DistributedOptimizer(
        hvd.fused_adam(model.parameters(), 3e-4, weight_decay=1e-4),
        axis="dp")
    param_bytes = sum(p.numel() * p.element_size()
                      for p in model.parameters())
    loss = tt.transformer_loss(model, mine, cfg, fsdp_group=mesh)
    loss.backward()
    opt.synchronize()
    replicated_equal = _replicated_equal(model)
    loss_mean = _world_mean(loss.detach())
    got = _whole_grads(model, cfg, mesh)
    whole_params = sum(g.numel() for g in got.values())
    check = (_check_one_card("par_cards_fsdp", loss_mean, got,
                             lm_config(SS_SEQ), tokens)
             if r == 0 else None)
    del got
    model.zero_grad(set_to_none=True)
    dist.barrier()
    assert replicated_equal

    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    with _CollectiveCount(mesh.get_group("fsdp")) as calls:
        times, losses = run_lm_steps(model, opt, mine, cfg, 3,
                                     fsdp_group=mesh)
    launches = counters()
    state_bytes = sum(t.numel() * t.element_size()
                      for st in opt.optimizer.state.values()
                      for t in st.values() if torch.is_tensor(t))
    assert all(math.isfinite(x) for x in losses), losses
    assert launches["_smallseq_fwd_kernel"] == 48 * 3, launches
    assert launches["_smallseq_bwd_kernel"] == 24 * 3, launches
    assert launches["_adam_kernel"] == 3, launches
    if r == 0:
        steady = _steady(times)
        replicated = whole_params * 4
        emit({"phase": "par_cards_fsdp", "cards": n, "model": "bert-large",
              "fsdp": n, "seq": SS_SEQ, "batch_per_card": PAR_FSDP_BATCH,
              "check_vs_one_card": check,
              "replicated_grads_equal_on_every_card": replicated_equal,
              "param_bytes_per_card": param_bytes,
              "optimizer_state_bytes_per_card": state_bytes,
              "param_bytes_replicated": replicated,
              "optimizer_state_bytes_replicated": 2 * replicated,
              "memory_allocated_model_and_state_gb":
                  (torch.cuda.memory_allocated() - base) / 1e9,
              "losses_rank0": losses, "step_s_rank0": times,
              "steady_step_s": steady,
              "tokens_per_s_per_card": PAR_FSDP_BATCH * SS_SEQ / steady,
              "fsdp_all_gather_per_step":
                  len(calls.calls["all_gather_into_tensor"]) / 3,
              "peak_mem_gb_rank0": torch.cuda.max_memory_allocated() / 1e9,
              "launches_rank0": launches,
              "wall_s": time.perf_counter() - t0, "card": smi})
    del model, opt, tokens, mine
    gc.collect()
    torch.cuda.empty_cache()


def par_cards_dp2_tp2(hvd, smi):
    """par_cards_dp2_tp2: bert-large on a dp 2 x tp 2 mesh, seq 512, 32
    rows a dp member (global 64), HVDT_FLASH_SMALLSEQ=on,
    DistributedOptimizer(fused_adam, axis="dp"): 3 steps against one card
    running the global batch with fused_adam from the same seed: each
    step's loss (the dp members' mean), the first step's gradients and
    the parameters after 3 steps (gathered over tp)."""
    import dataclasses

    import torch.distributed as dist

    from horovod_tpu_torch.models import transformer as tt
    from horovod_tpu_torch.parallel import make_mesh

    r = dist.get_rank()
    t0 = time.perf_counter()
    mesh = make_mesh(dp=2, tp=2)
    d, t = mesh.get_local_rank("dp"), mesh.get_local_rank("tp")
    os.environ["HVDT_FLASH_SMALLSEQ"] = "on"
    cfg = dataclasses.replace(lm_config(SS_SEQ), tp=2)
    tokens = _lm_tokens(9, 2 * PAR_DPTP_BATCH, SS_SEQ, cfg.vocab)
    mine = tokens[d * PAR_DPTP_BATCH:(d + 1) * PAR_DPTP_BATCH]
    model = tt.transformer_init(0, cfg, tp_rank=t)
    opt = hvd.DistributedOptimizer(
        hvd.fused_adam(model.parameters(), 3e-4, weight_decay=1e-4),
        axis="dp")
    losses, first = [], None
    times = []
    reset_counters()
    for step in range(3):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        opt.zero_grad()
        loss = tt.transformer_loss(model, mine, cfg, tp_group=mesh)
        loss.backward()
        opt.synchronize()
        if step == 0:
            replicated_equal = _replicated_equal(model)
            first = _whole_grads(model, cfg, mesh)
        opt.optimizer.step()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
        losses.append(_world_mean(loss.detach()))
    launches = counters()
    params = _whole_grads(model, cfg, mesh, grads=False)
    check = None
    if r == 0:
        one_cfg = lm_config(SS_SEQ)
        ref = tt.transformer_init(0, one_cfg)
        ref_opt = hvd.fused_adam(ref.parameters(), 3e-4, weight_decay=1e-4)
        ref_losses, grad_errs = [], None
        for step in range(3):
            ref_opt.zero_grad()
            ref_loss = tt.transformer_loss(ref, tokens, one_cfg)
            ref_loss.backward()
            if step == 0:
                grad_errs = {k: _rel_l2([first[k]], [p.grad])
                             for k, p in ref.named_parameters()}
            ref_opt.step()
            ref_losses.append(ref_loss.item())
        param_errs = {k: _rel_l2([params[k]], [p.detach()])
                      for k, p in ref.named_parameters()}
        loss_errs = [abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)]
        check = {"losses_members": losses, "losses_one_card": ref_losses,
                 "loss_rel_err": loss_errs,
                 "grad_rel_l2_max_step1": max(grad_errs.values()),
                 "param_rel_l2_max_step3": max(param_errs.values()),
                 "param_rel_l2_step3": param_errs,
                 "tolerances": [PAR_LOSS_TOL, PAR_GRAD_TOL]}
        del ref, ref_opt
        gc.collect()
        torch.cuda.empty_cache()
        emit({"phase": "par_cards_dp2_tp2", "cards": dist.get_world_size(),
              "model": "bert-large", "dp": 2, "tp": 2, "seq": SS_SEQ,
              "batch_per_dp_member": PAR_DPTP_BATCH,
              "check_vs_one_card": check,
              "replicated_grads_equal_on_every_card": replicated_equal,
              "step_s_rank0": times, "steady_step_s": _steady(times),
              "tokens_per_s": 2 * PAR_DPTP_BATCH * SS_SEQ / _steady(times),
              "launches_rank0": launches,
              "wall_s": time.perf_counter() - t0, "card": smi})
        assert max(loss_errs) <= PAR_LOSS_TOL, check
        assert max(grad_errs.values()) <= PAR_GRAD_TOL, grad_errs
        assert max(param_errs.values()) <= PAR_GRAD_TOL, param_errs
    assert replicated_equal
    assert launches["_smallseq_fwd_kernel"] == 48 * 3, launches
    assert launches["_smallseq_bwd_kernel"] == 24 * 3, launches
    assert launches["_adam_kernel"] == 3, launches
    del model, opt, tokens, mine, first, params
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()


def par_cards_sp_dp(hvd, smi):
    """par_cards_sp_dp: bert-large on a dp 2 x sp 2 mesh at global seq
    4096 (2048 a ring member), 4 rows a dp member, HVDT_RING_PALLAS=1
    (#9-#11 in every ring step), DistributedOptimizer(fused_adam,
    axis="dp") averaging over sp in its fold: one step's loss (the
    members' mean) and gradients against one card running the global
    batch on the whole sequence with the members' loss (each shard's own
    targets); then 3 steps with the ring's launches."""
    import dataclasses

    import torch.distributed as dist

    from horovod_tpu_torch.models import transformer as tt
    from horovod_tpu_torch.parallel import make_mesh

    r = dist.get_rank()
    t0 = time.perf_counter()
    mesh = make_mesh(dp=2, sp=2)
    d, s = mesh.get_local_rank("dp"), mesh.get_local_rank("sp")
    os.environ["HVDT_RING_PALLAS"] = "1"
    cfg = dataclasses.replace(lm_config(PAR_SPDP_SEQ), sp=2)
    tokens = _lm_tokens(10, 2 * PAR_SPDP_BATCH, PAR_SPDP_SEQ, cfg.vocab)
    shard = PAR_SPDP_SEQ // 2
    mine = tokens[d * PAR_SPDP_BATCH:(d + 1) * PAR_SPDP_BATCH,
                  s * shard:(s + 1) * shard].contiguous()
    try:
        model = tt.transformer_init(0, cfg)
        opt = hvd.DistributedOptimizer(
            hvd.fused_adam(model.parameters(), 3e-4, weight_decay=1e-4),
            axis="dp")
        loss = tt.transformer_loss(model, mine, cfg, sp_group=mesh)
        loss.backward()
        opt.synchronize()
        replicated_equal = _replicated_equal(model)
        loss_mean = _world_mean(loss.detach())
        got = {k: p.grad.detach().float() for k, p in
               model.named_parameters()}
        check = (_check_one_card("par_cards_sp_dp", loss_mean, got,
                                 lm_config(PAR_SPDP_SEQ), tokens, sp=2)
                 if r == 0 else None)
        del got
        model.zero_grad(set_to_none=True)
        dist.barrier()
        assert replicated_equal
        torch.cuda.reset_peak_memory_stats()
        reset_counters()
        times, losses = run_lm_steps(model, opt, mine, cfg, 3,
                                     sp_group=mesh)
        launches = counters()
    finally:
        del os.environ["HVDT_RING_PALLAS"]
    per = (s + 1) * cfg.layers          # ring steps a pass (causal)
    assert all(math.isfinite(x) for x in losses), losses
    assert launches["_kernel"] == 2 * per * 3, launches
    assert launches["_dq_kernel"] == per * 3, launches
    assert launches["_dkv_kernel"] == per * 3, launches
    assert launches["_adam_kernel"] == 3, launches
    every = _gather_obj({"launches": launches, "step_s": times}, 4)
    if r == 0:
        steady = max(_steady(x["step_s"]) for x in every)
        emit({"phase": "par_cards_sp_dp", "cards": 4, "model": "bert-large",
              "dp": 2, "sp": 2, "global_seq": PAR_SPDP_SEQ,
              "batch_per_dp_member": PAR_SPDP_BATCH,
              "check_vs_one_card": check,
              "replicated_grads_equal_on_every_card": replicated_equal,
              "losses_rank0": losses, "step_s_by_rank":
                  [x["step_s"] for x in every], "steady_step_s": steady,
              "tokens_per_s": 2 * PAR_SPDP_BATCH * PAR_SPDP_SEQ / steady,
              "peak_mem_gb_rank0": torch.cuda.max_memory_allocated() / 1e9,
              "launches_by_rank": [x["launches"] for x in every],
              "wall_s": time.perf_counter() - t0, "card": smi})
    del model, opt, tokens, mine
    gc.collect()
    torch.cuda.empty_cache()


def par_cards_sp_pp(hvd, smi):
    """par_cards_sp_pp: bert-large on a pp 2 x sp 2 mesh (12 layers a
    stage, m = 2 microbatches, the ring of each stage's two cards inside
    its layers: #9-#11 on bf16), seq 512 (256 a ring member), the same 32
    rows on both stages, DistributedOptimizer(fused_adam, axis="dp",
    pipeline="pp"): one step's loss and gradients (gathered over pp)
    against one card running 24 layers on the whole sequence with the
    members' loss; ring launches a step."""
    import dataclasses

    import torch.distributed as dist

    from horovod_tpu_torch.models import transformer as tt
    from horovod_tpu_torch.parallel import make_mesh

    r = dist.get_rank()
    t0 = time.perf_counter()
    mesh = make_mesh(dp=1, pp=2, sp=2)
    stage, s = mesh.get_local_rank("pp"), mesh.get_local_rank("sp")
    cfg = dataclasses.replace(lm_config(SS_SEQ), sp=2, pp=2)
    tokens = _lm_tokens(11, PAR_SPPP_BATCH, SS_SEQ, cfg.vocab)
    shard = SS_SEQ // 2
    mine = tokens[:, s * shard:(s + 1) * shard].contiguous()
    model = tt.transformer_init(0, cfg, pp_rank=stage)
    opt = hvd.DistributedOptimizer(
        hvd.fused_adam(model.parameters(), 3e-4, weight_decay=1e-4),
        axis="dp", pipeline="pp")
    reset_counters()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    loss = tt.transformer_loss(model, mine, cfg, sp_group=mesh,
                               pp_group=mesh)
    loss.backward()
    opt.synchronize()
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t1
    launches = counters()
    replicated_equal = _replicated_equal(model)
    # The members' mean loss: every stage holds its ring member's.
    loss_mean = _world_mean(loss.detach())
    got = _whole_grads(model, cfg, mesh)
    check = (_check_one_card("par_cards_sp_pp", loss_mean, got,
                             lm_config(SS_SEQ), tokens, sp=2)
             if r == 0 else None)
    del got
    per = (s + 1) * cfg.layers_per_stage * 2     # ring steps x microbatches
    assert launches["_kernel"] == 2 * per, launches
    assert launches["_dq_kernel"] == per, launches
    assert launches["_dkv_kernel"] == per, launches
    every = _gather_obj(launches, 4)
    if r == 0:
        emit({"phase": "par_cards_sp_pp", "cards": 4, "model": "bert-large",
              "pp": 2, "sp": 2, "layers_per_stage": cfg.layers_per_stage,
              "microbatches": 2, "seq": SS_SEQ, "batch": PAR_SPPP_BATCH,
              "check_vs_one_card": check,
              "replicated_grads_equal_on_every_card": replicated_equal,
              "step_s_rank0": step_s, "launches_by_rank": every,
              "wall_s": time.perf_counter() - t0, "card": smi})
    assert replicated_equal
    del model, opt, tokens, mine
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()


def par_cards_graphed(hvd, smi):
    """par_cards_graphed_sp_dp / _pp: :func:`graphed_lm` on
    par_cards_sp_dp's configuration (dp 2 x sp 2, global seq 4096, 4
    rows a dp member, HVDT_RING_PALLAS=1: #9-#11 in every ring step,
    DistributedOptimizer(fused_adam, axis="dp") averaging over sp) and
    on par_cards_pp's (pp 4, seq 512, the same 128 rows on every stage,
    m = 4, HVDT_FLASH_SMALLSEQ=on: #12/#13 in every stage,
    DistributedOptimizer(fused_adam, axis="dp", pipeline="pp"))."""
    import dataclasses

    import torch.distributed as dist

    from horovod_tpu_torch.models import transformer as tt
    from horovod_tpu_torch.parallel import make_mesh

    r, n = dist.get_rank(), dist.get_world_size()
    mesh = make_mesh(dp=2, sp=2)
    d, s = mesh.get_local_rank("dp"), mesh.get_local_rank("sp")
    cfg = dataclasses.replace(lm_config(PAR_SPDP_SEQ), sp=2)
    tokens = _lm_tokens(10, 2 * PAR_SPDP_BATCH, PAR_SPDP_SEQ, cfg.vocab)
    shard = PAR_SPDP_SEQ // 2
    mine = tokens[d * PAR_SPDP_BATCH:(d + 1) * PAR_SPDP_BATCH,
                  s * shard:(s + 1) * shard].contiguous()

    def make_sp_dp():
        m = tt.transformer_init(0, cfg)
        return m, hvd.DistributedOptimizer(
            hvd.fused_adam(m.parameters(), 3e-4, weight_decay=1e-4),
            axis="dp")

    os.environ["HVDT_RING_PALLAS"] = "1"
    try:
        graphed_lm("par_cards_graphed_sp_dp", cfg, make_sp_dp, mine,
                   {"sp_group": mesh}, smi, dp=2, sp=2,
                   global_seq=PAR_SPDP_SEQ,
                   batch_per_dp_member=PAR_SPDP_BATCH)
    finally:
        del os.environ["HVDT_RING_PALLAS"]
    del tokens, mine

    mesh = make_mesh(dp=1, pp=n)
    os.environ["HVDT_FLASH_SMALLSEQ"] = "on"
    cfg = dataclasses.replace(lm_config(SS_SEQ), pp=n)
    gen = torch.Generator(device="cuda").manual_seed(6)
    tokens = torch.randint(0, cfg.vocab, (PAR_PP_BATCH, SS_SEQ),
                           generator=gen, device="cuda")

    def make_pp():
        m = tt.transformer_init(0, cfg, pp_rank=r)
        return m, hvd.DistributedOptimizer(
            hvd.fused_adam(m.parameters(), 3e-4, weight_decay=1e-4),
            axis="dp", pipeline="pp")

    graphed_lm("par_cards_graphed_pp", cfg, make_pp, tokens,
               {"pp_group": mesh}, smi, pp=n,
               layers_per_stage=cfg.layers_per_stage, microbatches=n,
               seq=SS_SEQ, batch=PAR_PP_BATCH)


def par_cards_tp_ep(hvd, smi):
    """par_cards_tp_ep: bert-large with 8 experts on a dp 1 x ep 2 x tp 2
    mesh (4 experts a rank, each expert's d_ff and the attention heads
    over tp, the router whole), seq 512, HVDT_FLASH_SMALLSEQ=on, 32 rows
    an ep member (the same on its two tp members; 64 in all),
    DistributedOptimizer(fused_adam, axis="dp", expert="ep").  At
    capacity factor 8 (no drops) one step's loss (the ep members' mean)
    and gradients (gathered over ep and tp) against one card running the
    64 rows with every expert local, at par_cards_moe's bounds: in f32
    (materialized attention) loss and gradients, in bf16 (#12/#13) the
    loss, the gradients' distance reported; then 3 steps at 1.25 in
    bf16: step seconds, tokens/s, the dropped fraction, #12/#13 and #1;
    par_cards_tp_ep_graphed: that step under donated_step against it
    eagerly (:func:`graphed_lm`)."""
    import dataclasses

    import torch.distributed as dist

    from horovod_tpu_torch.models import transformer as tt
    from horovod_tpu_torch.parallel import make_mesh

    r, n = dist.get_rank(), dist.get_world_size()
    t0 = time.perf_counter()
    mesh = make_mesh(dp=1, ep=2, tp=2)
    ep, tp = mesh.get_local_rank("ep"), mesh.get_local_rank("tp")
    one = dist.new_group([0])
    os.environ["HVDT_FLASH_SMALLSEQ"] = "on"
    cfg = dataclasses.replace(lm_config(SS_SEQ), num_experts=PAR_EXPERTS,
                              ep=2, tp=2)
    check_cfg = dataclasses.replace(cfg, capacity_factor=float(PAR_EXPERTS))
    tokens = _lm_tokens(13, 2 * PAR_TPEP_BATCH, SS_SEQ, cfg.vocab)
    mine = tokens[ep * PAR_TPEP_BATCH:(ep + 1) * PAR_TPEP_BATCH]
    groups = {"ep_group": mesh, "tp_group": mesh}
    model = tt.transformer_init(0, cfg, ep_rank=ep, tp_rank=tp)
    opt = hvd.DistributedOptimizer(
        hvd.fused_adam(model.parameters(), 3e-4, weight_decay=1e-4),
        axis="dp", expert="ep")
    checks, replicated_equal = {}, True
    # The check runs twice: in f32 (the materialized attention: the
    # whole-sequence kernels take 16-bit operands) its loss and
    # gradients are held; in bf16 (#12/#13 on the local heads) its loss
    # is held and its gradients are reported.  In bf16 the members round
    # their activations otherwise than one card (tp sums partial
    # products), and a router logit near a tie then sends a token to
    # another expert, which moves the gradients far more than the loss.
    for dtype in ("float32", "bfloat16"):
        ccfg = dataclasses.replace(check_cfg, dtype=getattr(torch, dtype))
        smallseq = dtype == "bfloat16"
        if smallseq:
            os.environ["HVDT_FLASH_SMALLSEQ"] = "on"
        else:
            os.environ.pop("HVDT_FLASH_SMALLSEQ", None)
        loss = tt.transformer_loss(model, mine, ccfg, **groups)
        loss.backward()
        opt.synchronize()
        loss_mean = _world_mean(loss.detach())
        drops_check = _moe_drops(model, mine, ccfg, **groups)
        replicated_equal = replicated_equal and _replicated_equal(model)
        got = _whole_grads(model, ccfg, mesh)
        model.zero_grad(set_to_none=True)
        if r == 0:
            ref_cfg = dataclasses.replace(ccfg, ep=1, tp=1)
            ref = tt.transformer_init(0, ref_cfg)
            ref_loss = tt.transformer_loss(ref, tokens, ref_cfg,
                                           ep_group=one)
            ref_loss.backward()
            # At top-1 the routed gate is v / v: the router's gradient
            # is rounding noise on both sides, held to be small against
            # the gradient of wq, not by relative error.
            router = {"got_norm": got["block.w_router"].norm().item(),
                      "one_card_norm": ref.block["w_router"].grad.float()
                      .norm().item(),
                      "wq_norm": got["block.wq"].norm().item()}
            errs = {k: _rel_l2([got[k]], [p.grad]) for k, p in
                    ref.named_parameters() if k != "block.w_router"}
            checks[dtype] = {
                "dropped_fraction_max": max(drops_check),
                "router_grad": router, "loss_members": loss_mean,
                "loss_one_card": ref_loss.item(),
                "loss_rel_err": abs(loss_mean - ref_loss.item())
                / abs(ref_loss.item()),
                "grad_rel_l2": errs, "grad_rel_l2_max": max(errs.values()),
                "grads_held": not smallseq}
            del ref, ref_loss
            assert max(drops_check) == 0.0, drops_check
            assert checks[dtype]["loss_rel_err"] <= PAR_LOSS_TOL, checks
            if not smallseq:
                assert max(errs.values()) <= PAR_GRAD_TOL, errs
                assert router["got_norm"] <= 1e-2 * router["wq_norm"], \
                    router
        del got, loss
        gc.collect()
        torch.cuda.empty_cache()
        dist.barrier()
    check = ({"capacity_factor": check_cfg.capacity_factor,
              "tolerances": [PAR_LOSS_TOL, PAR_GRAD_TOL], **checks}
             if r == 0 else None)
    assert replicated_equal

    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    times, losses = run_lm_steps(model, opt, mine, cfg, 3, **groups)
    launches = counters()
    drops = _moe_drops(model, mine, cfg, **groups)
    assert all(math.isfinite(x) for x in losses), losses
    assert launches["_smallseq_fwd_kernel"] == 48 * 3, launches
    assert launches["_smallseq_bwd_kernel"] == 24 * 3, launches
    assert launches["_adam_kernel"] == 3, launches
    every = _gather_obj({"step_s": times, "launches": launches}, n)
    if r == 0:
        steady = max(_steady(x["step_s"]) for x in every)
        emit({"phase": "par_cards_tp_ep", "cards": n, "model": "bert-large",
              "ep": 2, "tp": 2, "experts": PAR_EXPERTS, "seq": SS_SEQ,
              "batch_per_ep_member": PAR_TPEP_BATCH,
              "params_rank0": sum(p.numel() for p in model.parameters()),
              "check_vs_one_card": check,
              "replicated_grads_equal_on_every_card": replicated_equal,
              "capacity_factor": cfg.capacity_factor,
              "losses_rank0": losses,
              "step_s_by_rank": [x["step_s"] for x in every],
              "steady_step_s": steady,
              "tokens_per_s": 2 * PAR_TPEP_BATCH * SS_SEQ / steady,
              "dropped_fraction_by_layer_rank0": drops,
              "peak_mem_gb_rank0": torch.cuda.max_memory_allocated() / 1e9,
              "launches_by_rank": [x["launches"] for x in every],
              "wall_s": time.perf_counter() - t0, "card": smi})
    del model, opt
    gc.collect()
    torch.cuda.empty_cache()

    # The same step under donated_step against it eagerly.
    def make():
        m = tt.transformer_init(0, cfg, ep_rank=ep, tp_rank=tp)
        return m, hvd.DistributedOptimizer(
            hvd.fused_adam(m.parameters(), 3e-4, weight_decay=1e-4),
            axis="dp", expert="ep")

    graphed_lm("par_cards_tp_ep_graphed", cfg, make, mine, groups, smi,
               ep=2, tp=2, experts=PAR_EXPERTS, seq=SS_SEQ,
               batch_per_ep_member=PAR_TPEP_BATCH)
    del tokens, mine


def parallel_cards_worker() -> None:
    """One rank of ``--parallel-cards``: :func:`par_cards_moe`,
    :func:`par_cards_pp`, :func:`par_cards_4d`, :func:`par_cards_tp`,
    :func:`par_cards_fsdp`, :func:`par_cards_dp2_tp2`,
    :func:`par_cards_sp_dp`, :func:`par_cards_sp_pp`,
    :func:`par_cards_graphed`, :func:`par_cards_tp_ep` and
    :func:`par_cards_sweeps` in an NCCL world of one process a card, each
    under a watchdog that names it.  Rank 0 prints the lines."""
    import torch.distributed as dist

    import horovod_tpu_torch as hvd

    hvd.init()
    smi = phase_device() if hvd.rank() == 0 else None
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for knob in ("HVDT_MOE_CAPACITY_FACTOR", "HVDT_PIPELINE_MICROBATCHES",
                 "HVDT_TRANSPORT"):
        os.environ.pop(knob, None)
    try:
        for phase in (par_cards_moe, par_cards_pp, par_cards_4d,
                      par_cards_tp, par_cards_fsdp, par_cards_dp2_tp2,
                      par_cards_sp_dp, par_cards_sp_pp, par_cards_graphed,
                      par_cards_tp_ep, par_cards_sweeps):
            with _PhaseTimeout(phase.__name__):
                phase(hvd, smi)
                dist.barrier()
    except BaseException:
        # As dp_cards_worker: a failed rank exits at once so the parent
        # stops the others.
        import traceback

        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)
    hvd.shutdown()


def parallel_cards(n: int) -> int:
    """``python3 chip_smoke.py --parallel-cards 4``: build the kernels,
    then run :func:`parallel_cards_worker` as 4 processes, one a card, in
    an NCCL world (rank 0 prints the lines).  A rank that fails stops
    them all."""
    if n != PAR_CARDS or not torch.cuda.is_available() \
            or torch.cuda.device_count() < n:
        print(f"chip_smoke: --parallel-cards takes {PAR_CARDS} and needs "
              f"{PAR_CARDS} CUDA cards", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import horovod_tpu_torch  # noqa: F401  (fails outside the repo)

    t0 = time.perf_counter()
    smi = phase_device()
    phase_build()
    rc = _spawn_ranks(n, "--parallel-worker", PAR_CARDS_TIMEOUT_S)
    if rc:
        return rc
    emit({"phase": "parallel_cards_total",
          "wall_s": time.perf_counter() - t0})
    _last_lines(smi)
    return 0


# ---- slice 19: the runtime plane (elastic state, the launcher) -------------

ELASTIC_STEPS = 20
ELASTIC_COMMIT = 5
ELASTIC_LR = 0.01               # a card's share: the LR is this x size
ELASTIC_PLAN = "exc@step=12"
ELASTIC_LAUNCH_PLAN = "crash@step=12"
ELASTIC_CARDS_PLAN = "crash@step=10:rank=3"
ELASTIC_RESIZE_STEPS = 30
ELASTIC_SCENARIO_TIMEOUT_S = 420
# The default bench leg's img/s as PR 13's chip run recorded it (PERF.md
# section 5: leg D on an NVIDIA H100 80GB HBM3 at 700 W), a constant: no
# run of this script measures it.
PR13_LEG_D_IMG_S = 1110.84


def _elastic_dataset(samples: int, device="cuda"):
    """``samples`` bf16 images (224x224) and labels, made on the device
    from one seed: every process of a job holds the same data."""
    g = torch.Generator(device=device).manual_seed(19)
    images = torch.randn((samples, IMAGE, IMAGE, 3), generator=g,
                         device=device, dtype=torch.bfloat16)
    labels = torch.randint(0, 1000, (samples,), generator=g, device=device)
    return images, labels


def _elastic_setup():
    """The knobs every elastic run shares (in-process and each worker):
    fused convs (#4), TF32 off, deterministic cuDNN, no plan left over
    from an earlier phase."""
    os.environ["HVDT_FUSED_CONV1X1"] = "1"
    for knob in ("HVDT_OVERLAP", "HVDT_ZERO", "HVDT_TRANSPORT",
                 "HVDT_COMPRESSION", "HVDT_QUANT", "HVDT_REMAT"):
        os.environ.pop(knob, None)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


def elastic_job(hvd, steps: int, *, fused: bool, samples: int,
                path=None, log=None, device="cuda"):
    """ResNet-50 (224x224, bf16 compute, f32 params, batch 64 a card)
    under ``hvd.elastic.run`` with ``TorchState(model, optimizer,
    sampler=ElasticSampler, batch)``, committed every ELASTIC_COMMIT
    steps; the LR is ELASTIC_LR x the world size at every (re)entry.
    The optimizer is interop.torch.DistributedOptimizer(fused_sgd) or,
    with ``fused``, the port's DistributedOptimizer(fused_sgd): its fixed
    bucket plan keeps NCCL's reduction order from run to run (the
    interop hooks fuse what each cycle finds ready).  The step loop fires
    the fault plan's ``step`` point before each step, as bench.py's
    does.  Returns (model, optimizer, state, marks): host times of the
    first entry, the faulted step and the first step after a re-entry."""
    from horovod_tpu_torch.data import ElasticSampler
    from horovod_tpu_torch.interop.torch_elastic import TorchState
    from horovod_tpu_torch.models import ResNetConfig, resnet50_init
    from horovod_tpu_torch.resilience import faults

    model = resnet50_init(0, ResNetConfig())
    opt = _fused_opt(hvd, model) if fused else _interop_opt(hvd, model)
    images, labels = _elastic_dataset(samples, device)
    marks = {"built": time.time()}
    state = TorchState(model, opt, sampler=ElasticSampler(
        samples, shuffle=True, seed=5), batch=0, path=path)
    marks["resumed"] = time.time()
    marks["restored_from"] = state.restored_from
    marks["start_batch"] = state.batch
    entries = []
    from horovod_tpu_torch import telemetry

    # Under HVDT_TELEMETRY a StepTimer feeds the history (HVDT_HISTORY)
    # that the workers' KV snapshots carry to the driver's roll-up.
    timer = (telemetry.StepTimer(examples_per_step=BATCH)
             if telemetry.enabled() else None)

    @hvd.elastic.run
    def train(state):
        entries.append(time.time())
        lr = ELASTIC_LR * hvd.size()
        for group in opt.param_groups:
            group["lr"] = lr
        inj = faults.get_injector()
        order = torch.tensor(list(state.sampler), device=images.device)
        k = 0
        while state.batch < steps:
            if inj is not None:
                t_fire = time.time()
                try:
                    inj.fire("step", step=state.batch + 1)
                except faults.InjectedFault:
                    marks["fault"] = t_fire
                    raise
            idx = order[k * BATCH:(k + 1) * BATCH]
            k += 1
            t_step = time.perf_counter()
            _resnet_step(model, opt, images[idx], labels[idx])
            state.sampler.record_batch(state.batch, BATCH)
            state.batch += 1
            if k == 1:
                torch.cuda.synchronize()
                marks.setdefault("first_steps", []).append(time.time())
            if log is not None:
                torch.cuda.synchronize()
                if timer is not None:
                    timer.observe(time.perf_counter() - t_step)
                with open(log, "a") as f:
                    f.write(f"{hvd.rank()} {hvd.size()} {state.batch} "
                            f"{round(lr * 1000)} "
                            f"{int(time.time() * 1000)}\n")
            if state.batch % ELASTIC_COMMIT == 0:
                state.commit()
        marks["end"] = time.time()

    train(state)
    torch.cuda.synchronize()
    marks["entries"] = entries
    return model, opt, state, marks


def _model_state(model) -> dict:
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _state_diff(got: dict, want: dict) -> dict:
    """Bytes equal, the largest absolute difference and whether every
    value is finite, over a model's parameters and BN statistics."""
    assert got.keys() == want.keys()
    equal = all(torch.equal(_bits(got[k].cpu()), _bits(want[k].cpu()))
                for k in got)
    floats = [k for k in got if got[k].is_floating_point()]
    err = max(_bit_err(got[k], want[k].to(got[k].device)) for k in floats)
    finite = all(bool(torch.isfinite(got[k]).all()) for k in floats)
    return {"equal_bytes": equal, "max_abs_err": err, "finite": finite,
            "tensors": len(got)}


def phase_elastic(hvd, smi):
    """elastic — the in-process retry loop in the NCCL world of one: an
    uninterrupted ELASTIC_STEPS run, then the same run with
    HVDT_FAULT_PLAN=exc@step=12 (restore the batch-10 commit, _reset:
    shutdown + init, sync, steps 11-20 again).  Final parameters and BN
    statistics equal in every byte; the recovery's ms (restore,
    re-init, re-sync, first step; no step is captured, so nothing is
    recaptured); #2's launches.  Returns the uninterrupted state (the
    yardstick of elastic_launch)."""
    from horovod_tpu_torch.telemetry import step_stats

    t0 = time.perf_counter()
    _elastic_setup()
    samples = ELASTIC_STEPS * BATCH
    reset_counters()
    model, opt, _, base_marks = elastic_job(hvd, ELASTIC_STEPS, fused=False,
                                            samples=samples)
    base_launches = counters()
    base = _model_state(model)
    opt._hvdt.remove()
    del model, opt
    _free()
    assert base_launches["_sgd_kernel"] == ELASTIC_STEPS, base_launches

    os.environ["HVDT_FAULT_PLAN"] = ELASTIC_PLAN
    os.environ["HVDT_TELEMETRY"] = "1"
    step_stats.reset_recovery_ledger()
    try:
        reset_counters()
        model, opt, state, marks = elastic_job(hvd, ELASTIC_STEPS,
                                               fused=False, samples=samples)
        launches = counters()
        phases = step_stats.recovery_ledger().recovery_snapshot()
    finally:
        del os.environ["HVDT_FAULT_PLAN"]
        del os.environ["HVDT_TELEMETRY"]
        step_stats.reset_recovery_ledger()
    diff = _state_diff(_model_state(model), base)
    opt._hvdt.remove()
    del model, opt, state
    _free()
    assert hvd.is_initialized() and hvd.size() == 1
    # 11 steps before the fault, 10 after the restore to batch 10.
    want_steps = ELASTIC_STEPS + 1
    assert launches["_sgd_kernel"] == want_steps, launches
    assert launches["_mm_stats_kernel"] == 26 * want_steps, launches
    assert len(marks["entries"]) == 2, marks
    assert diff["equal_bytes"] and diff["finite"], diff
    restore_ms = 1e3 * phases["restore"]
    reinit_ms = 1e3 * phases["rendezvous"]
    total_ms = 1e3 * (marks["first_steps"][1] - marks["fault"])
    first_ms = 1e3 * (marks["first_steps"][1] - marks["entries"][1])
    emit({"phase": "elastic", "model": "resnet50", "batch": BATCH,
          "image": IMAGE, "steps": ELASTIC_STEPS, "commit_every":
          ELASTIC_COMMIT, "fault_plan": ELASTIC_PLAN,
          "optimizer": "interop.torch.DistributedOptimizer(fused_sgd)",
          "final_vs_uninterrupted": diff, "launches": launches,
          "uninterrupted_launches": base_launches,
          "recovery_ms": {"total": total_ms, "restore": restore_ms,
                          "reinit": reinit_ms,
                          "resync": total_ms - restore_ms - reinit_ms
                          - first_ms,
                          "first_step": first_ms, "recapture": None},
          "uninterrupted_step_ms": 1e3 * (base_marks["end"]
                                          - base_marks["first_steps"][0])
          / (ELASTIC_STEPS - 1),
          "wall_s": time.perf_counter() - t0, "card": smi})
    return base


def _discovery_script(path: str, control: str, before: str, after: str):
    """A discovery script printing ``before`` until ``control`` exists,
    then ``after`` (the reference's scripted schedule)."""
    with open(path, "w") as f:
        f.write(f"#!/bin/sh\nif [ -f {control} ]; then echo {after}; "
                f"else echo {before}; fi\n")
    os.chmod(path, 0o755)
    return path


def _rows(log: str) -> list:
    if not os.path.exists(log):
        return []
    with open(log) as f:
        return [tuple(map(int, ln.split())) for ln in f if ln.strip()]


def _kill_workers(workdir: str) -> None:
    """Kill what is left of this run's launcher: the processes whose
    environment holds ``CHIP_SMOKE_ELASTIC_DIR=workdir``, this run's own
    temporary directory (the workers run in sessions of their own)."""
    import signal

    mark = f"CHIP_SMOKE_ELASTIC_DIR={workdir}".encode()
    for pid in os.listdir("/proc"):
        if not pid.isdigit() or int(pid) == os.getpid():
            continue
        try:
            with open(f"/proc/{pid}/environ", "rb") as f:
                env = f.read().split(b"\0")
        except OSError:
            continue
        if mark in env:
            try:
                os.kill(int(pid), signal.SIGKILL)
            except OSError:
                pass


def run_launcher(name: str, workdir: str, launcher_args: list,
                 worker_args: list, env: dict, flip=None,
                 timeout_s: float = ELASTIC_SCENARIO_TIMEOUT_S) -> str:
    """One ``python -m horovod_tpu_torch.runner.launch`` run of this
    script's ``--elastic-worker`` under a watchdog that names ``name``
    if it hangs.  ``flip``: (control file, predicate over the log rows),
    the control file made once the predicate holds.  Returns the run's
    output; raises unless it exits 0."""
    import socket

    here = os.path.dirname(os.path.abspath(__file__))
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    tag = f"--elastic-worker={name}"
    cmd = [sys.executable, "-m", "horovod_tpu_torch.runner.launch",
           "--coordinator-port", str(port), "--reset-limit", "3",
           *launcher_args, "--", sys.executable,
           os.path.abspath(__file__), tag, *worker_args]
    full_env = dict(os.environ, **env,
                    PYTHONPATH=here + os.pathsep
                    + os.environ.get("PYTHONPATH", ""))
    for knob in ("HVDT_FAULT_PLAN", "HVDT_RANK", "HVDT_SIZE",
                 "HVDT_LOCAL_RANK", "HVDT_LOCAL_SIZE",
                 "HVDT_COORDINATOR_ADDR", "HVDT_TELEMETRY"):
        if knob not in env:
            full_env.pop(knob, None)
    out_path = os.path.join(workdir, f"{name}.out")
    with open(out_path, "wb") as out:
        proc = subprocess.Popen(cmd, env=full_env, cwd=here, stdout=out,
                                stderr=subprocess.STDOUT)
        deadline = time.time() + timeout_s
        try:
            while proc.poll() is None:
                if flip is not None and not os.path.exists(flip[0]) \
                        and flip[1](_rows(env["CHIP_SMOKE_ELASTIC_LOG"])):
                    open(flip[0], "w").close()
                if time.time() > deadline:
                    print(f"chip_smoke: elastic phase {name} timed out "
                          f"after {timeout_s} s", file=sys.stderr,
                          flush=True)
                    break
                time.sleep(0.2)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            _kill_workers(workdir)
    with open(out_path) as f:
        text = f.read()
    if proc.returncode != 0:
        print(text[-6000:], file=sys.stderr)
        raise RuntimeError(f"elastic phase {name}: the launcher exited "
                           f"{proc.returncode}")
    return text


def _worker_env(workdir: str, name: str, **extra) -> dict:
    return {"CHIP_SMOKE_ELASTIC_DIR": workdir,
            "CHIP_SMOKE_ELASTIC_LOG": os.path.join(workdir, f"{name}.log"),
            "HVDT_FAULT_JOURNAL": os.path.join(workdir, f"{name}.journal"),
            **extra}


def elastic_worker(name: str, steps: int, fused: bool) -> int:
    """One slot of an elastic launcher run (``--elastic-worker=NAME``):
    init on the slot's card, :func:`elastic_job` with its commits
    persisted to the run's state file, one JSON line of host times per
    process (start, imports done, init, data and model built, resumed,
    first step) and, on rank 0, the final model state."""
    import horovod_tpu_torch as hvd

    t_imported = time.time()
    workdir = os.environ["CHIP_SMOKE_ELASTIC_DIR"]
    _elastic_setup()
    hvd.init()
    t_init = time.time()
    try:
        world = int(os.environ.get("CHIP_SMOKE_ELASTIC_MAX_WORLD",
                                   hvd.size()))
        reset_counters()
        # A path a rank: each rank's BN statistics are its own.  The
        # peer-store run keeps no disk commit at all.
        path = (None if os.environ.get("CHIP_SMOKE_ELASTIC_NO_DISK")
                else os.path.join(workdir,
                                  f"{name}.state.rank{hvd.rank()}.pt"))
        model, _, state, marks = elastic_job(
            hvd, steps, fused=fused, samples=steps * world * BATCH,
            path=path, log=os.environ["CHIP_SMOKE_ELASTIC_LOG"])
        doc = {"rank": hvd.rank(), "size": hvd.size(),
               "generation": int(os.environ.get("HVDT_GENERATION", 0)),
               "start": _T_START, "imported": t_imported, "init": t_init,
               "built": marks["built"], "resumed": marks["resumed"],
               "restored_from": marks["restored_from"],
               "start_batch": marks["start_batch"],
               "first_step": marks["first_steps"][0],
               "launches": counters(), "peer": _peer_counts()}
        with open(os.path.join(workdir, f"{name}.marks"), "a") as f:
            f.write(json.dumps(doc) + "\n")
        if hvd.rank() == 0:
            torch.save(_model_state(model),
                       os.path.join(workdir, f"{name}.final.pt"))
        hvd.shutdown()
    except BaseException:
        # A failed rank leaves its peers blocked in a collective: exit at
        # once (the driver ends the generation).
        import traceback

        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)
    return 0


def _peer_counts() -> dict:
    """This process's peer-tier counters (empty with the tier off)."""
    from horovod_tpu_torch.telemetry import metrics

    reg = metrics.default_registry()
    return {name: reg.get(name).total() for name in (
        "hvdt_peer_restore_total", "hvdt_peer_commit_total",
        "hvdt_peer_miss_total") if reg.get(name) is not None}


def _marks(workdir: str, name: str) -> list:
    with open(os.path.join(workdir, f"{name}.marks")) as f:
        return [json.loads(ln) for ln in f if ln.strip()]


def _restart_split(rows: list, marks: list) -> dict:
    """Host ms of a process restart: from the last step the dead
    generation logged to the (first) respawned process's start, its
    imports, init(), building the model and data, the resume from the
    persisted commit, and its first step."""
    m = min((x for x in marks if x["generation"] > 1),
            key=lambda x: x["start"])
    t_dead = max(ts for *_, ts in rows if ts < 1e3 * m["start"]) / 1e3
    return {"detect_and_respawn": 1e3 * (m["start"] - t_dead),
            "imports": 1e3 * (m["imported"] - m["start"]),
            "init": 1e3 * (m["init"] - m["imported"]),
            "build": 1e3 * (m["built"] - m["init"]),
            "resume": 1e3 * (m["resumed"] - m["built"]),
            "first_step": 1e3 * (m["first_step"] - m["resumed"]),
            "total": 1e3 * (m["first_step"] - t_dead)}


def phase_elastic_launch(smi, base: dict):
    """elastic_launch — the port's hvdtrun --elastic on one card: a
    discovery script printing localhost:1, crash@step=12 (the worker dies
    before step 12; its last persisted commit is batch 10), a disk
    state, a 1 s blacklist cooldown.  The driver respawns the generation,
    the new process resumes from the commit, and the final parameters
    and BN statistics equal the in-process uninterrupted run's in every
    byte.  The restart's ms split into its parts."""
    import tempfile

    t0 = time.perf_counter()
    _free()
    workdir = tempfile.mkdtemp(prefix="chip_smoke_elastic_")
    try:
        _elastic_launch_run(smi, base, workdir, t0)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def _elastic_launch_run(smi, base: dict, workdir: str, t0: float):
    name = "launch"
    disc = _discovery_script(os.path.join(workdir, "discover.sh"),
                             os.path.join(workdir, "never"),
                             "localhost:1", "localhost:1")
    env = _worker_env(workdir, name)
    out = run_launcher(name, workdir,
                       ["--host-discovery-script", disc, "--min-np", "1",
                        "--max-np", "1", "--blacklist-cooldown", "1",
                        "--fault-plan", ELASTIC_LAUNCH_PLAN],
                       [str(ELASTIC_STEPS), "interop"], env)
    rows = _rows(env["CHIP_SMOKE_ELASTIC_LOG"])
    marks = _marks(workdir, name)
    final = torch.load(os.path.join(workdir, f"{name}.final.pt"),
                       map_location="cuda")
    diff = _state_diff(final, base)
    # The crashed process wrote no marks (os._exit); its successor did.
    gens = sorted({m["generation"] for m in marks})
    batches = [b for _, _, b, _, _ in rows]
    assert gens == [2], (gens, out[-2000:])
    assert "rendezvous generation 3" not in out, out[-2000:]
    assert batches == list(range(1, 12)) + list(range(11, 21)), batches
    assert marks[-1]["restored_from"] == "disk"
    assert marks[-1]["start_batch"] == 10, marks[-1]
    assert diff["equal_bytes"] and diff["finite"], diff
    emit({"phase": "elastic_launch", "fault_plan": ELASTIC_LAUNCH_PLAN,
          "generations": 2, "batches_logged": len(batches),
          "final_vs_uninterrupted": diff,
          "restart_ms": _restart_split(rows, marks),
          "driver": [ln for ln in out.splitlines()
                     if ln.startswith("elastic:")],
          "respawned_worker_launches": marks[-1]["launches"],
          "wall_s": time.perf_counter() - t0, "card": smi})


def _resize(name: str, workdir: str, before: int, after: int, smi):
    """A discovery schedule from ``localhost:before`` to
    ``localhost:after`` once the old world logged a batch past its first
    commit: the reference's log contract (the new world resumes past
    batch 1, every rank of it logs, the LR is rescaled with the world,
    the target is reached) and the recovery's ms."""
    control = os.path.join(workdir, f"{name}.flip")
    disc = _discovery_script(os.path.join(workdir, f"{name}.sh"), control,
                             f"localhost:{before}", f"localhost:{after}")
    env = _worker_env(workdir, name, CHIP_SMOKE_ELASTIC_MAX_WORLD=str(
        max(before, after)))
    out = run_launcher(
        name, workdir,
        ["--host-discovery-script", disc, "--min-np", str(min(before, after)),
         "--max-np", str(max(before, after))],
        [str(ELASTIC_RESIZE_STEPS), "fused"], env,
        flip=(control, lambda rows: any(b > ELASTIC_COMMIT + 1
                                        for _, _, b, _, _ in rows)))
    rows = _rows(env["CHIP_SMOKE_ELASTIC_LOG"])
    marks = _marks(workdir, name)
    sizes = {s for _, s, _, _, _ in rows}
    first_new = next(b for _, s, b, _, _ in rows if s == after)
    lrs = {s: {lr for _, s2, _, lr, _ in rows if s2 == s} for s in sizes}
    last_old = max(ts for _, s, _, _, ts in rows if s == before)
    t_new = min(ts for _, s, _, _, ts in rows if s == after)
    assert sizes == {before, after}, (sizes, out[-2000:])
    assert first_new > 1, rows
    assert max(b for _, _, b, _, _ in rows) == ELASTIC_RESIZE_STEPS
    assert {r for r, s, _, _, _ in rows if s == after} == set(range(after))
    assert lrs == {s: {round(ELASTIC_LR * s * 1000)} for s in sizes}, lrs
    new = [m for m in marks if m["size"] == after]
    assert {m["rank"] for m in new} == set(range(after))
    split = {k: max(1e3 * (m[k] - m["start"]) for m in new)
             for k in ("imported", "init", "built", "resumed",
                       "first_step")}
    emit({"phase": f"elastic_cards_{name}", "world": [before, after],
          "first_batch_of_new_world": first_new,
          "lr_milli_by_world": {str(k): sorted(v) for k, v in lrs.items()},
          "recovery_ms": t_new - last_old,
          "new_world_ms_from_process_start": split,
          "driver": [ln for ln in out.splitlines()
                     if ln.startswith("elastic:")], "card": smi})


def elastic_cards(n: int) -> int:
    """``python3 chip_smoke.py --elastic-cards 4``: the port's hvdtrun
    --elastic across 4 cards (one worker process a card, an NCCL world
    made afresh each generation), ResNet-50 at batch 64 a card under the
    port's DistributedOptimizer(fused_sgd): an uninterrupted 4-slot run;
    the same with crash@step=10:rank=3 (the driver terminates the
    survivors, respawns the world of 4, which resumes from the batch-5
    commit), its final parameters against the uninterrupted run's;
    localhost:4 then localhost:2 (shrink) and localhost:2 then
    localhost:4 (grow), each with the reference's log contract.  Each
    scenario runs under a watchdog that names it."""
    import tempfile

    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        print(f"chip_smoke: --elastic-cards {n} needs {n} CUDA cards",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import horovod_tpu_torch  # noqa: F401  (fails outside the repo)

    t0 = time.perf_counter()
    smi = phase_device()
    phase_build()
    workdir = tempfile.mkdtemp(prefix="chip_smoke_elastic_cards_")
    try:
        _elastic_cards_run(n, smi, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    emit({"phase": "elastic_cards_total", "wall_s": time.perf_counter() - t0})
    _last_lines(smi)
    return 0


def _elastic_cards_run(n: int, smi, workdir: str):
    """The four scenarios of :func:`elastic_cards` in ``workdir``."""
    disc = _discovery_script(os.path.join(workdir, "four.sh"),
                             os.path.join(workdir, "never"),
                             f"localhost:{n}", f"localhost:{n}")
    fixed = ["--host-discovery-script", disc, "--min-np", str(n),
             "--max-np", str(n)]
    run_launcher("uninterrupted", workdir, fixed,
                 [str(ELASTIC_STEPS), "fused"],
                 _worker_env(workdir, "uninterrupted"))
    env = _worker_env(workdir, "crash")
    out = run_launcher("crash", workdir,
                       [*fixed, "--blacklist-cooldown", "1",
                        "--fault-plan", ELASTIC_CARDS_PLAN],
                       [str(ELASTIC_STEPS), "fused"], env)
    rows = _rows(env["CHIP_SMOKE_ELASTIC_LOG"])
    marks = _marks(workdir, "crash")
    want = torch.load(os.path.join(workdir, "uninterrupted.final.pt"),
                      map_location="cuda:0")
    got = torch.load(os.path.join(workdir, "crash.final.pt"),
                     map_location="cuda:0")
    diff = _state_diff(got, want)
    respawned = [m for m in marks if m["generation"] > 1]
    assert {m["rank"] for m in respawned} == set(range(n)), marks
    assert all(m["start_batch"] == ELASTIC_COMMIT for m in respawned), marks
    assert "terminating generation 1 after rank 3 failed" in out
    # The same buckets and communicator layout reduce in the same order:
    # the respawned world's parameters equal the uninterrupted run's.
    assert diff["equal_bytes"] and diff["finite"], diff
    disk_split = _restart_split(rows, marks)
    emit({"phase": "elastic_cards_crash", "fault_plan": ELASTIC_CARDS_PLAN,
          "final_vs_uninterrupted": diff,
          "restart_ms": disk_split,
          "driver": [ln for ln in out.splitlines()
                     if ln.startswith("elastic:")], "card": smi})
    _elastic_cards_peer(n, smi, workdir, fixed, want, disk_split)
    _resize("shrink", workdir, n, n // 2, smi)
    _resize("grow", workdir, n // 2, n, smi)


def _elastic_cards_peer(n: int, smi, workdir: str, fixed: list, want: dict,
                        disk_split: dict):
    """The crash run again with the telemetry plane and the peer tier on
    (HVDT_TELEMETRY, HVDT_PEER_STORE, HVDT_TRACE_DIR,
    HVDT_FLIGHT_RECORDER, HVDT_HISTORY, HVDT_EVENT_LOG) and no disk
    commit: every respawned rank restores its batch-5 commit from the
    peer tier over the driver's KV (hvdt_peer_restore_total 1, no state
    file), the final state equals the uninterrupted run's in every byte,
    the driver merges 4 ranks' traces into trace_merged.json and prints
    its roll-up over the 4 ranks' KV snapshots.  ``disk_split`` is the
    disk tier's restart split of this call's crash run, printed beside
    the peer tier's."""
    name = "peer"
    trace_dir = os.path.join(workdir, "trace")
    events = os.path.join(workdir, "events.jsonl")
    env = _worker_env(workdir, name, HVDT_TELEMETRY="1", HVDT_PEER_STORE="1",
                      HVDT_TRACE_DIR=trace_dir, HVDT_FLIGHT_RECORDER="1",
                      HVDT_EVENT_LOG=events, HVDT_HISTORY="1",
                      HVDT_HISTORY_SAMPLE_S="0",
                      HVDT_TELEMETRY_PUBLISH_S="1", HVDT_METRICS_PORT="0",
                      CHIP_SMOKE_ELASTIC_NO_DISK="1")
    out = run_launcher(name, workdir,
                       [*fixed, "--blacklist-cooldown", "1",
                        "--fault-plan", ELASTIC_CARDS_PLAN],
                       [str(ELASTIC_STEPS), "fused"], env)
    rows = _rows(env["CHIP_SMOKE_ELASTIC_LOG"])
    marks = _marks(workdir, name)
    got = torch.load(os.path.join(workdir, f"{name}.final.pt"),
                     map_location="cuda:0")
    diff = _state_diff(got, want)
    respawned = [m for m in marks if m["generation"] > 1]
    assert {m["rank"] for m in respawned} == set(range(n)), marks
    assert all(m["restored_from"] == "peer"
               and m["start_batch"] == ELASTIC_COMMIT
               and m["peer"].get("hvdt_peer_restore_total") == 1
               for m in respawned), respawned
    assert not [f for f in os.listdir(workdir)
                if f.startswith(f"{name}.state")], os.listdir(workdir)
    assert diff["equal_bytes"] and diff["finite"], diff
    with open(os.path.join(trace_dir, "trace_merged.json")) as f:
        merged = json.load(f)
    pids = sorted({e["pid"] for e in merged["traceEvents"]})
    assert pids == list(range(n)), pids
    lines = [ln for ln in out.splitlines() if ln.startswith("elastic:")]
    roll = json.loads(next(ln for ln in lines if ln.startswith(
        "elastic: telemetry roll-up "))[len("elastic: telemetry roll-up "):])
    assert roll["ranks"] == list(range(n)), roll
    split = _restart_split(rows, marks)
    emit({"phase": "elastic_cards_peer", "fault_plan": ELASTIC_CARDS_PLAN,
          "final_vs_uninterrupted": diff,
          "peer_counters": [m["peer"] for m in respawned],
          "restart_ms": split,
          "disk_restart_ms": disk_split,
          "merged_trace": {"pids": pids,
                           "events": len(merged["traceEvents"])},
          "rollup": {"ranks": roll["ranks"],
                     "unaligned_ranks": roll["unaligned_ranks"],
                     "aligned_steps": roll["aligned_steps"],
                     "per_pod": roll["per_pod"],
                     "wire_bytes_by_axis": roll["cluster"][
                         "wire_bytes_by_axis"],
                     "goodput_fraction_mean": roll["cluster"][
                         "goodput_fraction_mean"]},
          "event_log_lines": len(open(events).readlines())
          if os.path.exists(events) else 0,
          "driver": [ln for ln in lines
                     if not ln.startswith("elastic: telemetry roll-up")],
          "card": smi})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import ResNetConfig, resnet50_init

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = phase_device()
    phase_build()

    gen = torch.Generator(device="cuda").manual_seed(0)
    conv = phase_conv_kernels(gen, smi)

    os.environ["HVDT_FUSED_CONV1X1"] = "1"
    hvd.init()
    assert hvd.size() == 1 and hvd.topology().device.type == "cuda"
    cfg = ResNetConfig()          # depth 50, 1000 classes, bf16 compute
    model = resnet50_init(0, cfg)
    params = list(model.parameters())
    optim = phase_optim_kernels(params, gen)

    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = hvd.DistributedOptimizer(
        hvd.fused_sgd(model.parameters(), 0.01, momentum=0.9))
    images = torch.randn((BATCH, IMAGE, IMAGE, 3), generator=gen,
                         device="cuda")
    labels = torch.randint(0, cfg.num_classes, (BATCH,), generator=gen,
                           device="cuda")
    torch.cuda.reset_peak_memory_stats()
    steps = 3
    reset_counters()
    times, losses = run_steps(model, opt, images, labels, steps)
    train_launches = counters()
    assert all(math.isfinite(x) for x in losses), losses
    assert train_launches["_mm_stats_kernel"] == 26 * steps, train_launches
    assert train_launches["_sgd_kernel"] == steps, train_launches
    steady = sorted(times[1:])[len(times[1:]) // 2]
    emit({"phase": "train", "model": "resnet50", "batch": BATCH,
          "image": IMAGE, "steps": steps, "losses": losses,
          "step_s": times, "steady_step_s": steady,
          "images_per_s": BATCH / steady,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "launches": train_launches, "card": smi})

    x = images[:16]
    reset_counters()
    model.eval()
    with torch.no_grad():
        logits = model(x)
    torch.cuda.synchronize()
    eval_launches = counters()
    assert eval_launches["_mm_kernel"] == 26, eval_launches
    os.environ["HVDT_FUSED_CONV1X1"] = "0"
    with torch.no_grad():
        ref = model(x)
    os.environ["HVDT_FUSED_CONV1X1"] = "1"
    assert logits.shape == (16, cfg.num_classes)
    assert torch.isfinite(logits).all()
    # bf16 activations rounded at other places on the unfused path (the
    # 1x1 conv output, then x*a + b in bf16): a few bf16 ulps per layer,
    # so a relative L2 error of a few 1e-3 over the logits.
    eval_err = ((logits - ref).norm() / ref.norm()).item()
    eval_tol = 2e-2
    assert eval_err <= eval_tol, (eval_err, eval_tol)
    emit({"phase": "eval", "batch": 16, "launches": eval_launches,
          "rel_l2_err_vs_unfused": eval_err, "tolerance": eval_tol})

    model.train()
    adam = hvd.DistributedOptimizer(hvd.fused_adam(model.parameters(), 1e-3))
    reset_counters()
    a_times, a_losses = run_steps(model, adam, images, labels, 2)
    adam_launches = counters()
    assert all(math.isfinite(x) for x in a_losses), a_losses
    assert adam_launches["_adam_kernel"] == 2, adam_launches
    assert adam_launches["_mm_stats_kernel"] == 52, adam_launches
    emit({"phase": "adam", "steps": 2, "losses": a_losses, "step_s": a_times,
          "launches": adam_launches})

    quant, bucket_sizes = phase_quant_kernels(params, gen)

    int8_opt = hvd.quant.with_error_feedback(hvd.DistributedOptimizer(
        hvd.fused_sgd(model.parameters(), 0.01, momentum=0.9),
        compression=hvd.Compression.int8))
    steps = 3
    reset_counters()
    q_times, q_losses = run_steps(model, int8_opt, images, labels, steps)
    int8_launches = counters()
    want_q, want_dq = expected_quant_launches(hvd, model, steps,
                                             "int8")
    assert all(math.isfinite(x) for x in q_losses), q_losses
    assert int8_launches["_quant_kernel"] == want_q, (int8_launches, want_q)
    assert int8_launches["_dequant_kernel"] == want_dq, (int8_launches,
                                                         want_dq)
    assert int8_launches["_sgd_kernel"] == steps, int8_launches
    assert int8_launches["_mm_stats_kernel"] == 26 * steps, int8_launches
    int8_err = quant_exchange_matches_plain(hvd, model, hvd.quant.INT8_WIRE)
    assert int8_err == 0.0, int8_err
    # Step time against the uncompressed wire in turns (int8, plain,
    # plain, int8) on the same card and model.
    plain_opt = hvd.DistributedOptimizer(
        hvd.fused_sgd(model.parameters(), 0.01, momentum=0.9))
    p_times = (run_steps(model, plain_opt, images, labels, steps)[0]
               + run_steps(model, plain_opt, images, labels, steps)[0])
    q_times += run_steps(model, int8_opt, images, labels, steps)[0]
    del plain_opt
    # Where the step's extra time goes: error feedback over the 161
    # gradients, and the bucket exchange over each wire.
    grads = [p.grad for p in model.parameters()]
    split_ms = {"error_feedback": host_ms(int8_opt.compensate)}
    for wire in (None, hvd.quant.INT8_WIRE, hvd.quant.INT4_WIRE):
        split_ms[f"exchange_{wire or 'f32'}"] = host_ms(
            lambda: hvd.device.fused_allreduce(grads, wire_dtype=wire))
    q_steady = sorted(q_times[1:])[len(q_times[1:]) // 2]
    p_steady = sorted(p_times[1:])[len(p_times[1:]) // 2]
    emit({"phase": "int8", "steps": steps, "losses": q_losses,
          "step_s": q_times, "steady_step_s": q_steady,
          "images_per_s": BATCH / q_steady,
          "uncompressed_step_s": p_times,
          "uncompressed_steady_step_s": p_steady,
          "uncompressed_images_per_s": BATCH / p_steady,
          "buckets": bucket_sizes, "launches": int8_launches,
          "expected_quant_dequant": [want_q, want_dq],
          "exchange_vs_plain_max_abs_err": int8_err, "host_ms": split_ms,
          "card": smi})
    del int8_opt

    os.environ["HVDT_COMPRESSION"] = "int4"
    try:
        assert hvd.Compression.from_env() is hvd.Compression.int4
        int4_opt = hvd.quant.with_error_feedback(hvd.DistributedOptimizer(
            hvd.fused_sgd(model.parameters(), 0.01, momentum=0.9)),
            wire="int4")
        reset_counters()
        f_times, f_losses = run_steps(model, int4_opt, images, labels, 2)
        int4_launches = counters()
    finally:
        del os.environ["HVDT_COMPRESSION"]
    want_q4, want_dq4 = expected_quant_launches(hvd, model, 2, "int4")
    assert all(math.isfinite(x) for x in f_losses), f_losses
    assert int4_launches["_quant4_kernel"] == want_q4, int4_launches
    assert int4_launches["_dequant4_kernel"] == want_dq4, int4_launches
    assert int4_launches["_quant_kernel"] == 0, int4_launches
    assert int4_launches["_sgd_kernel"] == 2, int4_launches
    int4_err = quant_exchange_matches_plain(hvd, model, hvd.quant.INT4_WIRE)
    assert int4_err == 0.0, int4_err
    emit({"phase": "int4", "steps": 2, "losses": f_losses, "step_s": f_times,
          "launches": int4_launches,
          "expected_quant_dequant": [want_q4, want_dq4],
          "exchange_vs_plain_max_abs_err": int4_err})
    del int4_opt, adam, opt, model, params, images, labels, grads
    torch.cuda.empty_cache()

    phase_eager(hvd, gen, smi)
    phase_sync_bn(hvd, smi)
    phase_accumulate(hvd, smi)
    phase_wire_graphed(hvd, smi)
    phase_vgg_mlp(hvd, smi)
    phase_overlap(hvd, smi)
    phase_zero(hvd, smi)
    phase_ckpt(hvd, smi)
    phase_autotune(hvd, smi)
    phase_interop(hvd, smi)

    flash = phase_flash_kernels(gen, smi)
    phase_ring(gen, smi)
    lm_launches = phase_lm(hvd, gen, smi)
    flash.update(phase_smallseq_kernels(gen, smi))
    ss_launches, lm_shapes = phase_lm_smallseq(hvd, gen, smi)
    phase_lm_tp1(hvd, gen, smi)
    phase_fp8(hvd, gen, smi)
    phase_moe_dispatch(hvd, smi)
    phase_lm_moe(hvd, gen, smi)
    phase_lm_dots(hvd, gen, smi)
    bench_mm_err = phase_bench(hvd, smi)
    conv["_mm_stats_kernel"]["max_abs_err"] = max(
        conv["_mm_stats_kernel"]["max_abs_err"], bench_mm_err)
    phase_telemetry(hvd, smi)
    elastic_base = phase_elastic(hvd, smi)
    phase_elastic_launch(smi, elastic_base)
    del elastic_base
    _free()
    hvd.shutdown()
    phase_optim_lm(gen, smi, lm_shapes)

    sources = {"_mm_kernel": ("cuda", "horovod_tpu_torch/csrc/conv_fused.cu",
                              "horovod_tpu/ops/conv_fused.py:99",
                              eval_launches),
               "_mm_stats_kernel": ("cuda",
                                    "horovod_tpu_torch/csrc/conv_fused.cu",
                                    "horovod_tpu/ops/conv_fused.py:267",
                                    train_launches),
               "_sgd_kernel": ("cuda", "horovod_tpu_torch/csrc/optim.cu",
                               "horovod_tpu/ops/optim_kernels.py:289",
                               train_launches),
               "_adam_kernel": ("cuda", "horovod_tpu_torch/csrc/optim.cu",
                                "horovod_tpu/ops/optim_kernels.py:120",
                                adam_launches)}
    quant_cu = "horovod_tpu_torch/csrc/quant.cu"
    sources.update({
        "_quant_kernel": ("cuda", quant_cu, "horovod_tpu/quant/kernels.py:141",
                          int8_launches),
        "_dequant_kernel": ("cuda", quant_cu,
                            "horovod_tpu/quant/kernels.py:150",
                            int8_launches),
        "_quant4_kernel": ("cuda", quant_cu,
                           "horovod_tpu/quant/kernels.py:321",
                           int4_launches),
        "_dequant4_kernel": ("cuda", quant_cu,
                             "horovod_tpu/quant/kernels.py:328",
                             int4_launches)})
    flash_cu = "horovod_tpu_torch/csrc/flash_attn.cu"
    sources.update({
        name: ("cuda", flash_cu, f"horovod_tpu/ops/pallas_kernels.py:{line}",
               lm_launches)
        for name, line in (("_kernel", 89), ("_dq_kernel", 412),
                           ("_dkv_kernel", 461))})
    smallseq_cu = "horovod_tpu_torch/csrc/flash_smallseq.cu"
    sources.update({
        name: ("cuda", smallseq_cu,
               f"horovod_tpu/ops/pallas_kernels.py:{line}", ss_launches)
        for name, line in (("_smallseq_fwd_kernel", 614),
                           ("_smallseq_bwd_kernel", 662))})
    kernels = []
    for name, (route, source, replaces, launches) in sources.items():
        if name in conv:
            row = dict(conv[name])
            by = row.pop("bound_by")
            row["bound_by"] = max(by, key=by.get)
        elif name in quant:
            row = dict(quant[name], library_ms=None)
        elif name in flash:
            row = flash[name]
        else:
            row = dict(optim[name])
        kernels.append({"name": name, "route": route, "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": row["max_abs_err"],
                        "ms": row["kernel_ms"],
                        "plain_ms": row["plain_ms"],
                        "bound_ms": row["bound_ms"],
                        "bound_by": row["bound_by"],
                        "library_ms": row["library_ms"]})
    assert len(kernels) == 13, [k["name"] for k in kernels]
    emit({"phase": "total", "wall_s": time.perf_counter() - t_start})
    emit({"kernels": kernels})
    _last_lines(smi)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--ring-cards"]:
        sys.exit(ring_cards(int(sys.argv[2])))
    if sys.argv[1:2] == ["--ring-worker"]:
        sys.exit(ring_cards_worker())
    if sys.argv[1:2] == ["--eager-cards"]:
        sys.exit(eager_cards(int(sys.argv[2])))
    if sys.argv[1:2] == ["--eager-worker"]:
        sys.exit(eager_cards_worker())
    if sys.argv[1:2] == ["--eager-desync-worker"]:
        sys.exit(eager_desync_worker())
    if sys.argv[1:2] == ["--dp-cards"]:
        sys.exit(dp_cards(int(sys.argv[2])))
    if sys.argv[1:2] == ["--dp-worker"]:
        sys.exit(dp_cards_worker())
    if sys.argv[1:2] == ["--parallel-cards"]:
        sys.exit(parallel_cards(int(sys.argv[2])))
    if sys.argv[1:2] == ["--parallel-worker"]:
        sys.exit(parallel_cards_worker())
    if sys.argv[1:2] == ["--elastic-cards"]:
        sys.exit(elastic_cards(int(sys.argv[2])))
    if sys.argv[1:2] and sys.argv[1].startswith("--elastic-worker="):
        sys.exit(elastic_worker(sys.argv[1].split("=", 1)[1],
                                int(sys.argv[2]), sys.argv[3] == "fused"))
    sys.exit(main())
