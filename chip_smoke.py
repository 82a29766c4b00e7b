#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card.

    python3 chip_smoke.py            # from the repository root

Every phase fails loudly (exit code 1); none is caught and skipped.

1. Device: the card's name and power limit, and the build of the port's
   CUDA kernels from ``csrc/`` (one nvcc per source, all started at
   once): K1 and K6 in ``conv_implicit_gemm.cu``, K2-K5 in
   ``flash_attention.cu``, both on the shared Hopper helpers of
   ``hopper.cuh``, and R1 in ``row_gemm.cu``; the build seconds and
   what ``-Xptxas -v`` says of every kernel instance (registers, shared
   memory, spills), K2's instances,
   K3's and K5's, and K4's summarised on lines of their own; the HGMMA
   instructions of R1's tensor-core kernels in the built library's SASS
   (``cuobjdump -sass``), which must be there in each of its four.
2. K1 and K6 against K1's plain version (``conv_mxu._core_reference``, f32)
   at every launch shape of one ResNet-50 training step at batch 256
   (traced on the meta device, so they are the main path's own, each
   given as the padded input it reads as a window); K6 must equal K1 bit
   for bit.  Prints each shape's N tile and times K1, K6, the plain
   version and ``F.conv2d`` (cuDNN, a yardstick only) with CUDA events
   beside the bound.
3. ``conv2d_mxu`` forward and gradients (dx, dw), stride 1 and 2, against
   the ``patches`` lowering in f32 on the card.
3b. The input pipeline alone (``data/pipeline.py``): ResNet-50 batches at
   the full batch through ``HostPipeline`` (4 workers) and the CUDA
   ``DevicePrefetcher`` (page-locked staging, a copy stream), each read
   back on the card with the consumer's stream kept busy before the read
   and the batch dropped after it, must equal the host stream byte for
   byte; then both stages drained without a step for ResNet-50 and
   Inception-v3 batches at 1 and 4 workers: batches/s, host-to-device
   GB/s, pinned bytes and the waits.  The ImageNet records path is not
   driven: it needs PIL and OpenCV, which the card's machine lacks.  With
   ``--parent-tree DIR`` (another checkout, e.g. the parent commit's from
   ``git archive``) that tree's ``fit`` and this one's (in chunks of
   ``STEPS_PER_LOOP``, the step captured and replayed) train every zoo
   path in turns (parent, this, this, parent), each run a process of its
   own, every run timed over the same steps (those after the first chunk,
   a few seconds of the captured step): rates, each window's steps and
   milliseconds, and peak memory.
   ``--ab-only`` runs phase 1 and these alone.
3c. Replay against eager on every zoo path at full width (ResNet-50 K1,
   Inception-v3 K6, ResNet-32 f32 K1, VGG-16 and AlexNet K1, LeNet,
   ``transformer_lm`` K2-K4, ``transformer_lm_modern`` K2 + K5,
   ``ptb_medium``): ``REPLAY_STEPS`` steps of ``fit`` in chunks of
   ``STEPS_PER_LOOP`` (the first step eager, the rest replays of the
   captured step, a shorter tail on the same graph; ``REPLAY_STEPS_AHEAD``
   on the paths with short steps, where the host runs chunks ahead of the
   device, the most chunks in flight printed), its batches through the
   pipeline and the ``BatchStacker``, against the eager step on the
   dataset's own stream read serially:
   losses and every state tensor bit for bit where the step has no
   atomics, else (the LMs' embedding gradient) the losses to 1e-5
   relative and the state to 1e-4 in relative L2.
4. The ResNet-50 path: ``fit`` trains ``resnet50_synthetic`` (224x224,
   batch 256) with ``DTM_CONV_IMPL=mxu``; K1's counter must equal its
   launches per step times the steps (K6's stays 0).  The ``F.conv2d``
   arm (cuDNN) follows as a yardstick (one arm each since PR 21, which
   cut the second pair for time); then three steps through the CLI (K1
   50 a step).
5. ``torch.profiler`` over two replays of each ResNet arm's captured
   step: device time by kernel class and the device's idle share.  Each
   profile (here and in every phase) traces one more replay first and
   leaves it out, and is taken again, up to three times in all, if its
   replays' graph launches do not hold the same kernels: the profiler
   lost device records.
5b. Data parallel: the process joins a world-1 NCCL group through the
   port's ``launch.initialize_from_env`` (``DTM_*`` set by the script:
   127.0.0.1, a free port, 1 process, id 0), and ``resnet50_synthetic``
   (batch 256, K1 on every 3x3 conv, chunks of ``STEPS_PER_LOOP``) trains
   through ``fit`` in it, after ``fit`` without a group (no group,
   group).  The grouped arm's losses and state must equal the first
   arm's bit for bit; the collective counters
   must show one gradient bucket, each BatchNorm's moments and their
   cotangents (53 each) and one metric vector per step, replays included
   (none without the group); K1 50 a step in every arm; and a profile of
   two replays in the group must see, under each replay's graph launch,
   one NCCL kernel per collective, and none outside the replays (each
   all-reduce is a sum pre-multiplied by 1, which NCCL runs as a kernel at
   one rank too).  Images/s of each arm, the NCCL kernels'
   device time a step and peak memory are printed.  The group is
   destroyed before phase 6.
5c. Checkpoint/resume (``harness/checkpoint.py``) on the same path, every
   ``fit`` capturing the step once: (a) 12 steps straight against 8
   steps and a second ``fit`` to 12 from the step-8 checkpoint, every
   state tensor and the losses of steps 9-12 bit for bit; (b) the newest
   step torn (its ``state.pt`` truncated), the resume walking back to step
   8 and ending bit-identical; (c) ``nan_policy="rollback"`` with batch 6
   poisoned by a dataset wrapper here: exactly the chunk of steps 5-8
   skipped, one rollback, still one capture (the restore is in place
   under the live graph), and every state tensor and loss bit for bit
   those of a straight ``fit`` over the dataset without batches 5-8; (d) the save's cost, recorded only: a save
   every 4 steps after a run with none, each save's snapshot and write
   seconds and bytes, ``checkpoint/fence`` and images/s.
   ``--resume-only`` runs phases 1 and 5c alone.
5d. A run's telemetry and its evaluation: ``resnet50_synthetic`` (batch
   256) through ``fit`` with a workdir for ``TELEMETRY_STEPS`` steps, the
   hooks every ``TELEMETRY_EVERY``: a K1 arm and an ``F.conv2d`` arm,
   each leaving ``telemetry.json`` (the four fractions summing to 1, the
   capture counted as a compile event), ``metrics.jsonl`` rows with the
   telemetry keys and TensorBoard events, both files passing
   ``scripts/check_metrics_schema.py``; ``flops_per_step`` must be the
   same on both arms and equal the count taken on the CPU
   (``R50_STEP_FLOPS_PER_IMAGE``).  The MFU (the report's, over the whole
   run, and over the timed window), the four fractions and each row's
   interval MFU are printed.  A K1 arm without ``TelemetryHook`` and
   ``TensorBoardHook`` follows (the hooks' host cost, in images/s).  Then
   ``evaluate_classification`` on the K1 arm's checkpoint over
   ``EVAL_BATCHES`` batches on K1, on ``F.conv2d`` and on K1's plain
   version: K1 launches 25 a batch, the top-1
   and top-5 verdicts and the xent held to the plain version's within
   ``EVAL_COUNT_TOL`` and ``EVAL_XENT_RTOL``, images/s of each; and
   ``transformer_lm`` trained ``LM_TRAIN_STEPS`` steps with flash and
   ``evaluate_lm`` over ``LM_EVAL_BATCHES`` batches on K2 (4 launches a
   batch) and on its plain version, the perplexity within
   ``LM_PPL_RTOL``; tokens/s of each.  ``--telemetry-only`` runs phases 1
   and 5d alone.
5e. Fault injection and the localhost fleet (``resilience/chaos.py``,
   ``launch.py``) on the ResNet-50 path (batch 256, K1, chunks of 4, a
   checkpoint every 4 steps), every ``fit`` capturing once, against a
   straight 8-step run: (a) ``nan_policy="rollback"`` with the NaN of
   ``nan_at_step=6`` written into the replayed chunk's second row: one
   rollback, the chunk's four batches skipped, state and losses bit for
   bit those of a straight run without them; (b) a 6-step run whose final
   save is torn (``torn_checkpoint_at_step``), resumed to 8 by walking
   back to step 4; (c) the CLI with ``--chaos sigterm_at_step=4`` exits 75
   and the same command resumes; (d) the CLI under ``python -m
   distributed_tensorflow_models_tpu_torch.launch --num-processes 1
   --max-restarts 1`` with ``--chaos kill_at_step=6``: the child SIGKILLs
   itself once, the launcher attributes it and relaunches, the relaunch
   resumes; each ending at the straight run's state bit for bit, K1 50
   launches for every step run (the relaunch's from its CLI line), the
   ``fleet/*`` gauges in its ``metrics.jsonl``, each drill's seconds and
   the relaunch's startup milestones printed.  ``--chaos-only`` runs
   phases 1 and 5e alone.
6. Phase 2 at every launch shape of one ``inception_v3_imagenet`` step at
   batch 256 (the 1x7, 7x1, 1x3, 3x1 taps, the aux head's 5x5, the phase
   kernels of its stride-2 convs and the dx of all of them).
7. The Inception-v3 path: ``fit`` trains ``inception_v3_imagenet``
   (299x299, batch 256, RMSProp, label smoothing, the 0.4-weighted aux
   head, L2, the weight EMA) with ``DTM_CONV_MXU_PIPELINE=1``: K6's
   counter must equal its launches per step times the steps and K1's must
   stay 0.  The K1 arm (knob 0) follows, then one ``F.conv2d``
   arm; images/s, step times, peak memory and losses of each, and
   profiles of the K6 and K1 arms as in phase 5.
8. K2-K5 (``csrc/flash_attention.cu``) against their plain versions in
   bf16 at (a) the LM path's launch shape B16 T256 H8 D32 causal, (b) the
   flash sweep shape B4 T2048 H8 D64 causal, (c) B4 T2048 H8 Hkv2 D32
   causal window 256, (d) a chunk call with nonzero q/kv offsets and an
   LSE cotangent, and (e) B4 T2048 H8 D128 causal.  K5's dS stage is
   filled with NaN first; its dK and dV must equal K3's bit for bit, and
   its dQ K4's (the count of elements that differ and the largest
   difference are printed).  At (a), (b), (c) and (e) each launch is
   timed against its bound and its plain version, K2 against
   ``F.scaled_dot_product_attention``'s forward and the backward launches
   against its backward (a yardstick only: the port never calls it; with
   ``enable_gqa`` and an explicit window mask at (c)); at each, the host
   time to encode K2's three TMA tensor maps, and every kernel's and both
   SDPA directions' time with the host's launch cost taken out (launches
   replayed in a CUDA graph; SDPA's backward as a fresh forward and
   backward less the fresh forward).  With ``--parent-csrc DIR`` (another
   tree's ``csrc/``, e.g. the parent commit's from ``git archive``) that
   tree's K2-K5 are built too, its K5 dQ is counted against its K4, and
   its kernels are replayed in turns with this tree's (parent, this,
   this, parent).  ``--flash-only`` runs phases 1 and 8 alone.  With
   ``--parent-csrc`` that tree's bf16 K1 also runs after phase 1, in turns
   with this tree's at every ResNet-50 launch shape, and must give the
   same bits.
9. The transformer_lm path: ``fit`` trains ``transformer_lm`` (4 layers, 8
   heads, d_model 256, sequence 256, batch 16) with ``--attn-impl
   flash``; K2, K3 and K4 must each launch 4 layers x steps times.  The
   blockwise arm (``auto``, which launches none) follows as a yardstick
   (one arm each since PR 21); a profile of each.
10. The transformer_lm_modern path: the same width with rotary positions,
   GQA (2 KV heads for 8) and a 256-token window, ``DTM_FLASH_BWD=staged``:
   K2 and both K5 launches must each equal layers x steps, K3 and K4 0.
   The pair backward follows (one arm each since PR 21); tokens/s and
   peak memory of each, and a profile of the staged arm.
11. K1 and K6 at every launch shape of the new conv paths, traced on the
   meta device as for phases 2 and 6: ``resnet32_cifar10`` at batch 128 in
   f32 (the kernels' f32 form: TF32 products, held elementwise to
   ``conv_mxu.tf32_error_bound`` and, against the plain version on
   tf32-cut operands, to ``conv_mxu.tf32_order_bound``, which a cast to
   bf16 would break; ``F.conv2d`` timed with cuDNN's TF32 on,
   and off beside it), VGG-16 at 224x224 and batch 64 and AlexNet at
   224x224 and batch 128 in bf16 (its 5x5 ``conv2`` and dx included); K6
   equal to K1 bit for bit in both dtypes; each shape's N tile, time,
   bound (the dense TF32 or bf16 peak, or the bytes) and cuDNN time.
12. The new conv paths through ``fit``, a K1 arm (``DTM_CONV_IMPL=mxu``)
   and an ``F.conv2d`` arm (one of each since PR 21): ``resnet32_cifar10`` (batch 128,
   f32; also a K6 arm) and ``lenet_mnist`` (batch 64; its convs route to
   patches, so no kernel launches) as named configs, VGG-16 and AlexNet
   on ``resnet50_synthetic`` with the JAX bench's settings (batch
   64 and 128, L2 5e-4, TF momentum at 0.1 x batch / 256; four input
   workers, since the bench feeds stacked device batches).  K1's counter
   must equal its traced launches a step times the steps (all f32 for
   ResNet-32), K6's stays 0 unless the knob picks it; images/s, the wait
   for input, step times, peak memory and losses of each arm; a profile of
   each K1 arm.
13. ``ptb_medium`` at full width (hidden 650, batch 20, 35 steps of
   unroll, vocab 10000, dropout 0.5) through ``fit``: tokens/s, the wait
   for input, step times, peak memory, losses finite and falling; then
   two steps of ``fit``, whose carry must reach step 2 as the model's
   zero carry threaded on, ``[20, 650]`` per layer, f32, detached.
14. The decode path (``harness/generate.py``, the model's ``KVCache``):
   ``transformer_lm`` trained ``GEN_TRAIN_STEPS`` steps on flash through
   ``fit`` with a workdir (K2-K4 4 launches a step each, counters zeroed
   just before); ``python -m ...harness.cli generate`` on its checkpoint
   in a process of its own, whose greedy tokens must equal this process's
   ``generate`` on the restored model; then ``transformer_lm`` (restored)
   and ``transformer_lm_modern`` (rotary, GQA 2 of 8, window 256; seeded
   init) at their widths, batch 16, a 256-token PTB prompt and
   ``GEN_NEW_TOKENS`` new tokens, which fill the 512-slot cache: greedy
   ``generate`` with the one-token step captured as a CUDA graph (one
   capture, a replay per later token) against every step eager, tokens
   and each step's logits bit for bit; the decode logits against the
   full forward of the generated sequence on K2 (one launch a layer,
   counted) within ``DECODE_ATOL_OF_SCALE`` of the logits' scale; a
   sampled stream (top-k 40, top-p 0.95) captured, eager and repeated
   from its seed, bit for bit; decode tokens/s captured and eager, timed
   in turns (two runs of each since PR 21).  Beam search (batch
   ``BEAM_BATCH``, ``BEAM_SIZE`` beams; one run of each since PR 21) and
   ``generate_rnn`` on ``ptb_medium`` (seeded init) captured against
   eager, bit for bit, timed.  R1 at each LM's decode shapes: every
   launch of its ``[16, 256]`` prompt pass and of one ``[16, 1]`` step
   against its plain version (the SIMT form bit for bit; the
   tensor-core form within ``_r1_excess``'s bound, and bit for bit with
   itself over its rows one at a time and in two halves), timed beside
   its bound and ``torch.matmul``; R1's counters zeroed just before the
   timed captured ``generate`` and read just after, where each form's
   must equal the prompt pass's launches of that form plus one step's
   for each later token.
   ``--generate-only`` runs phases 1 and 14.
15. The cold start (``harness/startup.py``): ``transformer_lm`` on flash
   resumed from phase 14's checkpoint for ``STARTUP_STEPS`` more steps,
   each arm of ``STARTUP_ARMS`` in a fresh process joined to a world-1
   NCCL group: the startup thread on and off (``aot_compile``), on the
   kept kernel build and on a fresh one (``xla_cache_dir=""``: nvcc into
   a temporary directory).  Every arm must resume at the checkpoint's
   step, capture once and end at the same losses.  Each prints the split
   of the time before its first step: the torch import, the port's
   import, CUDA and the NCCL group's init, and from its run's trace
   ``build_state``, the kernel loads and the FLOPs count (on the thread,
   or in the step), the restore, the thread's join, the pipeline's fill
   (the first chunk's wait), the eager step and the capture.
   ``--startup-only`` runs phase 1, phase 14's training and phase 15.
16. The Switch-MoE transformer and the model knobs, each run ``KNOB_STEPS``
   steps through ``fit``, the counters zeroed just before it and read just
   after: (a) ``transformer_lm_moe`` at its widths on flash (K2-K4 4
   launches a step each) against its eager steps (losses within 1e-5
   relative, state within 1e-4 in relative L2: the embedding gradient's
   atomics), its aux loss finite and positive; one ``moe_ffn`` at its 4096
   tokens on the card against the CPU (the share of equal expert choices,
   the rows routed alike within f32 summation order, aux and the dropped
   fraction).  (b) ``transformer_lm`` on flash, dropout 0.1, remat off and
   on (K2 8 launches a step under remat, K3 and K4 4): the same losses and
   state within the same bounds, so the recompute drew the forward's
   dropout masks.  (c) ResNet-50 (batch 256) and Inception-v3 (batch
   ``KNOB_INCEPTION_BATCH``) on K1, remat off and on: the BN running
   statistics bit for bit (a recompute that updated them would not be),
   K1's launches a step, the FLOPs counted.  (d) ``DTM_EMBED_GRAD=matmul``
   against ``scatter`` on one ``transformer_lm`` step's embedding
   gradient, and both backward lowerings timed.  (e) blockwise attention
   with ``block_q=64`` against the unchunked loop at B4 T2048 H8 D64
   causal bf16, output and gradients, both timed.  Every arm prints its
   tokens/s or images/s, step time and peak memory.  ``--model-knobs-only``
   runs phases 1 and 16.
17. Tensor and sequence parallelism, where the card holds one rank:
   (a) the ring's per-rank arithmetic at full width,
   ``parallel/ring.py::emulate`` (``ring_step`` for each of n = 2 and 4
   virtual ranks on the KV blocks in the order it receives them: K2
   forward, K3 + K4 backward per block, wholly masked blocks included) at
   FLASH_SHAPES (b) and (c), against one full ``flash_attention`` and
   the plain ``reference_attention`` on the same bf16 inputs within the
   K2-K4 tolerance, nothing non-finite, K2/K3/K4 n launches per virtual
   rank, the n-rank ring body and one full call timed per direction.  (b)
   ``transformer_lm`` with its ``param_rules="transformer_tp"`` and
   ``seq_impl="ring"`` at model and seq axes of one (flash, dropout 0.1,
   ``PAR_STEPS`` steps in chunks of 4, a world-1 NCCL group), in turns
   with the same fit without rules or ``seq_impl``: the same collectives
   a run and none on the axes of one, one capture a fit, K2/K3/K4 one
   launch a layer a step (the counters zeroed just before each arm), the
   losses and state within the LM bound; tokens/s and step time of each.
   (c) ``cnn_tp``'s split convolutions: K1 on each half of the output
   channels of every ResNet-50 launch shape at the batch, concatenated,
   against K1 on all of them, bit for bit (K1's routing rule reads kh,
   kw and Cin, not Cout, so the split moves no conv off K1).
   ``--parallel-only`` runs phases 1, 17 and 18.
18. Pipeline and expert parallelism, where the card holds one rank: (a)
   the pipelined ``transformer_lm`` stack at full width (4 layers, d 256,
   B16 T256, bf16, flash, dropout 0.1): ``PipelinedBlocks.emulate`` (the
   GPipe tick schedule of n = 2 and 4 virtual stages, lists rotated in
   place of the P2P exchanges) at 4 and 8 microbatches against the
   stack's sequential schedule on the same weights and dropout bits, the
   output and every gradient within the K2-K4 tolerance, K2/K3/K4 one
   launch a layer a microbatch.  (b) ``transformer_lm`` pipelined (pipe 1,
   4 microbatches, ``PAR_STEPS`` steps in chunks of 4, a world-1 NCCL
   group) in turns with the plain fit: K2/K3/K4 16 launches a step (4
   plain), the same collectives as the plain fit and none on ``pipe/*``,
   the replayed state against the eager steps within the LM bound (the
   bit-for-bit count printed), tokens/s of each.  (c) the expert layout's
   per-rank arithmetic, ``moe.emulate`` at E = 2 and 4 over
   ``transformer_lm_moe``'s 4096 tokens (d 256, f 1024, 4 experts, f32)
   against ``moe_ffn_reference(num_ranks=E)``: out, aux, dropped and the
   gradients; ``transformer_lm_moe`` at expert 1 in the NCCL group
   against the plain fit (phase 16's path), within the LM bound; one sum
   of an f32, bf16 and f16 tensor in the group, NCCL's pre-multiplied
   one printed and the port's required unchanged.
19. The reference's flagship async-PS vs sync A/B
   (``harness/experiment.py``) and its emulators, every counter zeroed
   at the phase's start: (a) ``async_vs_sync`` on ``resnet50_synthetic``
   (batch 256, K1) ``AB_STEPS`` steps a mode at K = 1 (async equals sync
   bit for bit, losses and every state tensor) and K = 4 (staleness 0, 1,
   2, 3, 3, ...; the replayed events equal the emulator run eagerly bit
   for bit), the emulator at staleness limit 2 (the drops the host
   predicts, the step the applied events), K1 50 launches a step and an
   event; (b) the backup emulator at M = 4, N = 3 on 64-row shards (the
   discarded shard zeroed leaves the state bit for bit, BN statistics one
   update by the last chosen replica, K1 150 launches a round); (c)
   ``async_vs_sync`` on ``transformer_lm`` (flash) at K = 1 (async
   against sync within the LM bound) and K = 2, K2-K4 4 launches a step
   and an event; (d) the CLI's ``ab`` in this process.  Each mode's
   seconds and images/s or tokens/s, its capture seconds, the staleness
   profile and peak memory are printed.
20. The serving engine (``serving/``) on ``transformer_lm`` at full
   width (its seeded init, bf16): (a) the invariance check: a 150-token
   prompt's logits and every block's K/V whole, in chunks of 32 and of
   1, and an ``[8, 1]`` step over per-lane lengths against each lane's
   ``[1, 1]`` step alone, all bit for bit; (b) R1 against its plain
   version at every launch of that decode step and of a ``[2, 32]``
   prefill dispatch (the SIMT form bit for bit, no tolerance: the same
   f32 additions in the same order; the tensor-core form within
   ``_r1_excess``'s bound, and bit for bit with itself over its rows one
   at a time and in two halves), each timed (R1, its plain version,
   ``torch.matmul`` on the same operands) beside its bound; (c) 16
   requests (prompts of
   17-200 tokens, 32-96 new, the six sampling modes in turn, four on a
   shared 128-token prefix, admitted mid-flight) through the engine (8
   slots, chunks of 32, 2 prefill lanes, pages of 16) after a warm-up
   request that builds its programs, R1's counters zeroed just before
   and read after (both forms launched, in one step's proportion): every
   stream equal to solo ``generate`` (captured, batch
   1), programs (1, 1), ``fsck()`` clean after every step, the shared
   prefix reused; served tokens/s against solo ``generate`` one request
   at a time, prefill and decode ms a dispatch; (d) ``decode_burst`` 4
   on four requests and ``spec_tokens`` 4 on a random and two repetitive
   prompts: streams equal solo, programs (1, 1) and (1, 2), drafts
   accepted printed.

Every training arm runs ``fit`` in chunks of ``STEPS_PER_LOOP`` steps
(``steps_per_loop``): the first step eager, the step then captured as a
CUDA graph once and every later step a replay (the arm fails otherwise);
each kernel's counter counts what each replay launches.  Every arm reads
its batches through ``fit``'s pipeline (``HostPipeline``, one worker,
then the CUDA ``DevicePrefetcher`` and the ``BatchStacker``) and prints
its images/s or tokens/s over the timed window (from a device sync at the
end of the first chunk to one at the run's end), its median and mean wait
for input (``data_s``), its capture's count and seconds, and its peak
memory, allocated and reserved (the graph's private pool).  Arms
compared run one after the other in one process (K1 then F.conv2d for
ResNet-50, flash then blockwise for transformer_lm; PR 21 cut the second
pair of phases 4, 9, 10 and 12 and the repeated decode and beam runs of
phase 14 after a 1126.3 s smoke): host noise on a shared machine moves
step times between runs.  The last
lines are the card's name and power limit, a ``{"kernels": ...}`` JSON line (K1
to K6, K5 as its two launches, K1's and K6's f32 forms as entries of their
own, and R1) and ``{"ok": true, "device": {...}}``.  ``--zoo-only`` runs phases 1
and 11-13 alone, ``--dp-only`` phases 1 and 5b, ``--resume-only`` phases
1 and 5c, ``--chaos-only`` phases 1 and 5e, ``--generate-only`` phases 1 and
14, ``--startup-only`` phases 1, 14's training and 15,
``--model-knobs-only`` phases 1 and 16, ``--parallel-only`` phases 1,
17 and 18, ``--async-only`` phases 1 and 19, ``--serve-only`` phases 1
and 20.  Each ``fit`` given a workdir under ``build/chip_smoke`` (emptied
at the start) saves a final checkpoint there, which the smoke deletes.
"""

from __future__ import annotations

import argparse
import collections
import concurrent.futures
import contextlib
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (dense bf16 and TF32 tensor cores, HBM3).
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES_PER_S = 3.35e12
# K1 writes bf16: its output rounding is at most half an ulp, 2^-8 of the
# value; the f32 sums run in another order than the plain version's.
# Allow one ulp (2^-7) relative plus 1e-3 of the output's scale.
K1_RTOL = 2.0 ** -7
K1_ATOL_OF_SCALE = 1e-3
# conv2d_mxu in bf16 against f32: each K1 output and each dw tap rounds to
# bf16 once, and a stride-2 forward adds its four phase outputs in bf16.
GRAD_TOL_OF_SCALE = 2.0 ** -6
K1_SOURCE = "distributed_tensorflow_models_tpu_torch/csrc/conv_implicit_gemm.cu"
K1_REPLACES = "distributed_tensorflow_models_tpu/ops/conv_mxu.py:174"
K6_REPLACES = "distributed_tensorflow_models_tpu/ops/conv_mxu.py:204"
FLASH_SOURCE = "distributed_tensorflow_models_tpu_torch/csrc/flash_attention.cu"
FLASH_KERNELS = (
    # id, its wrapper in ops/attention.py, the TPU kernel it replaces
    ("K2", "flash_forward", "distributed_tensorflow_models_tpu/ops/attention.py:578"),
    ("K3", "flash_dkv", "distributed_tensorflow_models_tpu/ops/attention.py:799"),
    ("K4", "flash_dq", "distributed_tensorflow_models_tpu/ops/attention.py:916"),
)
# K5's two launches: _flash_dkv_kernel(stage_ds=True) and
# _flash_dq_staged_kernel.
STAGED_KERNELS = (
    ("K5 dKV", "flash_dkv_staged",
     "distributed_tensorflow_models_tpu/ops/attention.py:799"),
    ("K5 dQ", "flash_dq_staged",
     "distributed_tensorflow_models_tpu/ops/attention.py:877"),
)
# K2-K4 against their plain versions in bf16: both round P and dS to bf16
# at the same points; they differ by the f32 summation order (the kernel
# rescales by a running max where the plain version sums at once), rare
# one-ulp flips of a rounded P or dS and each output's bf16 rounding (half
# an ulp).  Two ulps (2^-6) relative plus 1e-2 of the output's largest
# magnitude; the f32 LSE to 1e-4 absolute.
FLASH_RTOL = 2.0 ** -6
FLASH_ATOL_OF_SCALE = 1e-2
LSE_ATOL = 1e-4
# The input pipeline phase: batches read back and held to their host
# batches; batches drained per arm after the warm-up ones (enough of those
# to empty what both stages buffer and hold in flight at 4 workers, about
# 12 batches, so the timed window is the steady rate); and the spin that
# keeps the consumer's stream busy before each read (~20 ms at the H100's
# ~1.7 GHz).
PIPE_CHECK_BATCHES = 6
PIPE_WARM_BATCHES = 15
PIPE_DRAIN_BATCHES = 20
PIPE_SLEEP_CYCLES = 34_000_000
# Every training arm runs fit's K-step call: chunks of STEPS_PER_LOOP
# steps, the first step eager and every later one a replay of the step
# captured as a CUDA graph.  Phase 3c holds the steps of each path to
# eager ones: REPLAY_STEPS (a chunk, then a shorter tail on the same
# graph) on the device-bound paths, REPLAY_STEPS_AHEAD (four chunks and a
# tail, so the host can dispatch chunks past fit's first sync) on the
# paths where a replayed step is short.
STEPS_PER_LOOP = 4
REPLAY_STEPS = 6
REPLAY_STEPS_AHEAD = 18
# name, B, Tq, Tkv, H, Hkv, D, causal, window, q_offset, kv_offset,
# LSE cotangent, timed
FLASH_SHAPES = (
    ("a: LM main path", 16, 256, 256, 8, 8, 32, True, None, 0, 0, False, True),
    ("b: flash sweep", 4, 2048, 2048, 8, 8, 64, True, None, 0, 0, False, True),
    ("c: GQA + window", 4, 2048, 2048, 8, 2, 32, True, 256, 0, 0, False,
     True),
    ("d: chunk, offsets", 2, 256, 384, 8, 2, 64, True, None, 384, 256, True,
     False),
    ("e: D128 sweep", 4, 2048, 2048, 8, 8, 128, True, None, 0, 0, False,
     True),
)


def log(*args) -> None:
    print(*args, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    return out.splitlines()[0]


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def core_launch_shapes(model_name: str, image_size: int, batch: int,
                       channels: int = 3,
                       **model_kw) -> list[tuple[str, tuple, tuple]]:
    """``(role, xpad shape, kernel shape)`` of every launch of the conv
    core (K1, or K6 with ``DTM_CONV_MXU_PIPELINE=1``) in one training step
    of ``model_name`` at ``batch``, in order: the port's model run forward
    and backward on the meta device, with the core's forward recorded (it
    takes the plain version there: nothing is launched)."""
    import torch

    from distributed_tensorflow_models_tpu_torch.models import get_model
    from distributed_tensorflow_models_tpu_torch.ops import conv_mxu

    calls = []
    role = ["fwd"]
    core_window = conv_mxu._core_window

    def record(x, kernel, win, out=None):
        # The window's padded extent: the core's input as the padded route
        # materialised it.
        kh, kw, cin, _ = kernel.shape
        oh, ow = win[4], win[5]
        calls.append((role[0], (x.shape[0], oh + kh - 1, ow + kw - 1, cin),
                      tuple(kernel.shape)))
        return core_window(x, kernel, win, out)

    conv_mxu._core_window = record
    try:
        with torch.device("meta"):
            model = get_model(model_name, conv_impl="mxu", **model_kw)
            out = model(torch.empty(batch, image_size, image_size, channels),
                        train=True)
        role[0] = "dx"
        outs = out if isinstance(out, tuple) else (out,)
        sum(o.sum() for o in outs).backward()
    finally:
        conv_mxu._core_window = core_window
    return calls


def ptxas_summary(log: str) -> list[str]:
    """One line per kernel instance of an ``nvcc -Xptxas -v`` log (its
    mangled name, registers, shared memory, stack and spills), and every
    warning line as it is."""
    out, name = [], None
    for line in log.splitlines():
        if "warning" in line.lower():
            out.append(line.strip())
        elif "Compiling entry function" in line:
            name = line.split("'")[1] if "'" in line else line
            # Drop the anonymous namespace's mangled prefix.
            name = re.sub(r"^_ZN\d+_GLOBAL__N__\w+?_cu_[0-9a-f]+\d+", "",
                          name)[:72]
            props = []
        elif name and ("spill" in line or "Used" in line):
            props.append(line.split(":", 1)[-1].strip())
            if "Used" in line:
                out.append(f"{name}: " + "; ".join(props))
                name = None
    return out


def r1_sass_hgmma() -> dict:
    """HGMMA instructions in each tensor-core kernel of the built R1
    library (``cuobjdump -sass``), by kernel."""
    from distributed_tensorflow_models_tpu_torch.ops import rowwise

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", rowwise._load()._name],
                          capture_output=True, text=True, check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
        elif name and "dtm_row_gemm_tc_kernel" in name and "HGMMA" in line:
            counts[name] = counts.get(name, 0) + 1
    return counts


def k1_work(xshape, kshape, f32: bool = False) -> tuple[float, float]:
    """FLOPs and bytes (inputs read once, output written once) of one K1
    call, at 2 bytes an element (bf16) or 4 (f32)."""
    b, hp, wp, cin = xshape
    kh, kw, _, cout = kshape
    m = b * (hp - kh + 1) * (wp - kw + 1)
    flops = 2.0 * m * kh * kw * cin * cout
    nbytes = (4.0 if f32 else 2.0) * (b * hp * wp * cin + kh * kw * cin * cout
                                      + m * cout)
    return flops, nbytes


def bound_of(flops: float, nbytes: float, f32: bool = False
             ) -> tuple[float, str]:
    """Least time the card needs for that work, in ms: FLOPs over the
    dense bf16 (or, for f32 operands, TF32) peak or bytes over the memory
    rate, whichever is larger, and which of the two it is."""
    t_ops = flops / (PEAK_TF32_FLOPS if f32 else PEAK_BF16_FLOPS)
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def bound_ms(xshape, kshape, f32: bool = False) -> tuple[float, str]:
    """The bound of one K1 call (``bound_of`` its ``k1_work``)."""
    return bound_of(*k1_work(xshape, kshape, f32), f32)


def phase_k1(calls, seed: int, f32: bool = False,
             replay: bool = False) -> dict:
    """K1 against its plain version at each distinct launch shape, and K6,
    which must equal K1 bit for bit, timed beside it, in bf16 or (``f32``)
    in the kernels' f32 form.  Per-step totals weight each shape by its
    launches per step.  In f32 the checks are ``conv_mxu.tf32_error_bound``
    elementwise and, against the plain version on tf32-cut operands,
    ``conv_mxu.tf32_order_bound`` (printed as ``order_err``, the largest
    error in units of K 2^-24 sum|x~||w~|; the bound is 2), and ``F.conv2d``'s f32 time is taken with cuDNN's TF32 on
    (the kernel's precision) and, printed beside it, off.  K1, K6 and
    ``F.conv2d`` are timed with CUDA events over back-to-back calls or,
    with ``replay`` (shapes small enough that a call from Python costs
    more than the kernel), by CUDA-graph replay (``graph_ms``)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from distributed_tensorflow_models_tpu_torch.ops import conv_mxu

    dtype = torch.float32 if f32 else torch.bfloat16
    per_shape = collections.OrderedDict()
    for role, xs, ks in calls:
        per_shape.setdefault((xs, ks), collections.Counter())[role] += 1
    rng = np.random.default_rng(seed)
    rows, worst_abs, worst_rel = [], 0.0, 0.0
    totals = collections.Counter()
    log(f"{'xpad':>22} {'kernel':>18} {'per step':>12} {'tile':>8} "
        f"{'k1_ms':>9} {'k6_ms':>9} "
        f"{'plain_ms':>9} {'cudnn_ms':>9} {'bound_ms':>9} {'bound_by':>10} "
        f"{'TFLOP/s':>8} {'max_abs':>9} {'max_rel':>9}"
        + (f" {'cudnn_fp32':>10} {'order_err':>9}" if f32 else "")
        + f"   ({'f32, TF32 products' if f32 else 'bf16'}; cudnn_ms with "
        f"cudnn.allow_tf32={f32}; "
        f"{'CUDA-graph replay' if replay else 'events over calls'})")
    for (xs, ks), roles in per_shape.items():
        fan_in = ks[0] * ks[1] * ks[2]
        x = torch.from_numpy(rng.standard_normal(xs, dtype=np.float32)).cuda()
        k = torch.from_numpy(rng.standard_normal(ks, dtype=np.float32)
                             / math.sqrt(fan_in)).cuda()
        x, k = x.to(dtype), k.to(dtype)
        got = conv_mxu.conv_implicit_gemm(x, k)
        torch.cuda.synchronize()
        if got.dtype != dtype:
            fail(f"K1 wrote {got.dtype} for {dtype} inputs at x{xs} k{ks}")
        want = conv_mxu._core_reference(x.float(), k.float())
        err = (got.float() - want).abs()
        scale = float(want.abs().max())
        if f32:
            limit = conv_mxu.tf32_error_bound(x, k)
            what = "the TF32 bound (2^-9 + 2^-20 + 2K 2^-24) sum|x||w|"
        else:
            limit = K1_ATOL_OF_SCALE * scale + K1_RTOL * want.abs()
            what = (f"atol {K1_ATOL_OF_SCALE * scale:.3g} + rtol "
                    f"{K1_RTOL:.3g}")
        bad = err > limit
        del limit
        max_abs = float(err.max())
        max_rel = max_abs / scale
        if bool(bad.any()):
            fail(f"K1 disagrees with its plain version at x{xs} k{ks}: "
                 f"{int(bad.sum())} elements over {what}; max abs err "
                 f"{max_abs:.4g}")
        order_units = None
        if f32:
            # The same products as the kernel's (operands cut to tf32), so
            # only the f32 summation order may differ: bf16 operands, or
            # tf32 rounded to nearest, break this bound.
            err_t = (got - conv_mxu._core_reference(
                conv_mxu.tf32_cut(x), conv_mxu.tf32_cut(k))).abs()
            limit = conv_mxu.tf32_order_bound(x, k)
            order_units = 2 * float((err_t / limit).nan_to_num(0.0).max())
            n_bad = int((err_t > limit).sum())
            del err_t, limit
            if n_bad:
                fail(f"K1 disagrees with the plain version on tf32-cut "
                     f"operands at x{xs} k{ks}: {n_bad} elements over the "
                     f"order bound 2K 2^-24 sum|x~||w~| (max "
                     f"{order_units:.3g} K 2^-24 sum|x~||w~|)")
        got6 = conv_mxu.conv_implicit_gemm_pipelined(x, k)
        torch.cuda.synchronize()
        if not torch.equal(got6, got):
            fail(f"K6 differs from K1 at x{xs} k{ks}: "
                 f"{int((got6 != got).sum())} elements")
        del got6
        del got, want, err, bad
        # cuDNN's own layout: NHWC activations seen as NCHW, the weight
        # stored OHWI (channels_last OIHW), arranged outside the timing.
        x_nchw = x.permute(0, 3, 1, 2)
        w_cl = k.permute(3, 0, 1, 2).contiguous().permute(0, 3, 1, 2)
        timer = graph_ms if replay else (lambda fn: time_ms(fn, 20))
        ms = timer(lambda: conv_mxu.conv_implicit_gemm(x, k))
        k6_ms = timer(lambda: conv_mxu.conv_implicit_gemm_pipelined(x, k))
        plain_ms = time_ms(lambda: conv_mxu._core_reference(x, k), 5, 1)
        tf32_was = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = f32
        lib_ms = timer(lambda: F.conv2d(x_nchw, w_cl))
        torch.backends.cudnn.allow_tf32 = False
        lib_full_ms = timer(lambda: F.conv2d(x_nchw, w_cl)) if f32 else None
        torch.backends.cudnn.allow_tf32 = tf32_was
        bms, bound_by = bound_ms(xs, ks, f32)
        n = sum(roles.values())
        m = xs[0] * (xs[1] - ks[0] + 1) * (xs[2] - ks[1] + 1)
        tile = conv_mxu.tile_n(ks[3], m)
        tflops = 2.0 * m * ks[0] * ks[1] * ks[2] * ks[3] / (ms * 1e9)
        log(f"{str(xs):>22} {str(ks):>18} "
            f"{' '.join(f'{r}x{c}' for r, c in roles.items()):>12} "
            f"{f'128x{tile}':>8} {ms:9.4f} {k6_ms:9.4f} "
            + f"{plain_ms:9.4f} {lib_ms:9.4f} {bms:9.4f} "
            f"{bound_by:>10} {tflops:8.1f} {max_abs:9.3g} {max_rel:9.3g}"
            + (f" {lib_full_ms:10.4f} {order_units:9.3g}" if f32 else ""))
        rows.append(dict(xpad=xs, kernel=ks, roles=dict(roles), tile_n=tile,
                         ms=ms,
                         k6_ms=k6_ms, plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=bms, bound_by=bound_by, max_abs_err=max_abs,
                         max_rel_err=max_rel, order_err=order_units))
        for key, val in (("ms", ms), ("k6_ms", k6_ms), ("plain_ms", plain_ms),
                         ("library_ms", lib_ms), ("bound_ms", bms)):
            totals[key] += n * val
        worst_abs, worst_rel = max(worst_abs, max_abs), max(worst_rel, max_rel)
        del x, k, x_nchw, w_cl
        torch.cuda.empty_cache()
    # The bound of a step's K1 work is the larger total of the two sides.
    flops = sum(k1_work(xs, ks, f32)[0] for _, xs, ks in calls)
    nbytes = sum(k1_work(xs, ks, f32)[1] for _, xs, ks in calls)
    step_bound, step_bound_by = bound_of(flops, nbytes, f32)
    log(f"K1 per training step ({len(calls)} launches, "
        f"{'f32' if f32 else 'bf16'}): "
        f"{totals['ms']:.3f} ms; "
        + f"K6 {totals['k6_ms']:.3f} ms (K6 = K1 bit for bit at every "
        f"shape); "
        + f"plain {totals['plain_ms']:.3f} ms; "
        f"cuDNN {totals['library_ms']:.3f} ms; bound {step_bound:.3f} ms "
        f"({flops / 1e12:.3f} TFLOP, {nbytes / 1e9:.3f} GB); "
        f"K1 at {flops / (totals['ms'] * 1e9):.1f} TFLOP/s; "
        f"worst max abs err {worst_abs:.4g} (rel to scale {worst_rel:.4g})")
    return dict(rows=rows, ms=totals["ms"], k6_ms=totals["k6_ms"],
                plain_ms=totals["plain_ms"],
                library_ms=totals["library_ms"],
                bound_ms=step_bound, bound_by=step_bound_by,
                max_abs_err=worst_abs, max_rel_err=worst_rel)


def conv_call(lib, x, k):
    """bf16 K1 through ``lib``'s C entry (another build of
    ``conv_implicit_gemm.cu``) on a contiguous input, outside the port's
    wrappers and their counts."""
    import torch

    from distributed_tensorflow_models_tpu_torch.ops import _kernels, conv_mxu

    fn = lib.dtm_conv_window_bf16
    conv_mxu.bind_window(fn)
    b, h, w, cin = x.shape
    kh, kw, _, cout = k.shape
    oh, ow = h - kh + 1, w - kw + 1
    out = torch.empty(b, oh, ow, cout, dtype=x.dtype, device=x.device)
    rc = fn(x.data_ptr(), b, h, w, cin, *x.stride()[:3], 0, 0, 1, 1,
            k.data_ptr(), kh, kw, cout, out.data_ptr(), oh, ow,
            *out.stride()[:3], 0, torch.cuda.current_stream().cuda_stream)
    _kernels.check(lib, rc, "the other tree's K1")
    return out


def phase_conv_ab(calls, parent_lib, seed: int, card: str) -> None:
    """This tree's bf16 K1 and another tree's (``--parent-csrc``) at each
    distinct launch shape: outputs equal bit for bit, device times in
    turns (parent, this, this, parent; CUDA-graph replay, so that neither
    side's host cost per call, its wrapper's or this function's, enters),
    and the per-step totals."""
    import numpy as np
    import torch

    from distributed_tensorflow_models_tpu_torch.ops import conv_mxu

    per_shape = collections.Counter((xs, ks) for _, xs, ks in calls)
    rng = np.random.default_rng(seed)
    totals = collections.Counter()
    for (xs, ks), n in per_shape.items():
        x = torch.from_numpy(rng.standard_normal(xs, dtype=np.float32)).cuda()
        k = torch.from_numpy(rng.standard_normal(ks, dtype=np.float32)
                             / math.sqrt(ks[0] * ks[1] * ks[2])).cuda()
        x, k = x.bfloat16(), k.bfloat16()
        this = lambda: conv_mxu.conv_implicit_gemm(x, k)  # noqa: E731
        other = lambda: conv_call(parent_lib, x, k)  # noqa: E731
        if not torch.equal(this(), other()):
            fail(f"bf16 K1 differs from the parent tree's at x{xs} k{ks}")
        times = [graph_ms(fn) for fn in (other, this, this, other)]
        totals["parent"] += n * (times[0] + times[3]) / 2
        totals["this"] += n * (times[1] + times[2]) / 2
        log(f"bf16 K1 x{xs} k{ks} x{n}: parent {times[0]:.4f} / "
            f"{times[3]:.4f} ms, this {times[1]:.4f} / {times[2]:.4f} ms, "
            f"equal bit for bit")
        del x, k
    log(f"bf16 K1 per ResNet-50 step ({len(calls)} launches), in turns: "
        f"parent {totals['parent']:.3f} ms, this {totals['this']:.3f} ms; "
        f"outputs equal bit for bit at every shape | {card}")


def phase_grads(seed: int) -> None:
    """conv2d_mxu (K1 in bf16) forward, dx and dw against the patches
    lowering in f32 on the same values."""
    import numpy as np
    import torch

    from distributed_tensorflow_models_tpu_torch.ops import conv as convlib
    from distributed_tensorflow_models_tpu_torch.ops import conv_mxu

    rng = np.random.default_rng(seed)
    cases = [((32, 28, 28, 128), (3, 3, 128, 128), (1, 1)),
             ((32, 56, 56, 128), (3, 3, 128, 128), (2, 2))]
    for xs, ks, strides in cases:
        x = torch.from_numpy(rng.standard_normal(xs, dtype=np.float32))
        k = torch.from_numpy(rng.standard_normal(ks, dtype=np.float32)
                             / math.sqrt(ks[0] * ks[1] * ks[2]))
        x, k = x.cuda().bfloat16(), k.cuda().bfloat16()
        xb, kb = x.clone().requires_grad_(), k.clone().requires_grad_()
        x32 = x.float().requires_grad_()
        k32 = k.float().requires_grad_()
        before = conv_mxu.conv_implicit_gemm.launches
        y = conv_mxu.conv2d_mxu(xb, kb, strides, "SAME")
        g = torch.from_numpy(rng.standard_normal(tuple(y.shape),
                                                 dtype=np.float32)).cuda()
        y.backward(g.bfloat16())
        y32 = convlib.conv2d_patches(x32, k32, strides, "SAME")
        y32.backward(g.bfloat16().float())
        torch.cuda.synchronize()
        if conv_mxu.conv_implicit_gemm.launches == before:
            fail(f"conv2d_mxu {strides} launched no K1")
        for name, got, want in (("y", y.detach(), y32.detach()),
                                ("dx", xb.grad, x32.grad),
                                ("dw", kb.grad, k32.grad)):
            if got.dtype != torch.bfloat16 or got.shape != want.shape:
                fail(f"conv2d_mxu {strides} {name}: {got.dtype} "
                     f"{tuple(got.shape)} vs {tuple(want.shape)}")
            scale = float(want.abs().max())
            err = float((got.float() - want).abs().max())
            log(f"conv2d_mxu strides {strides} x{xs} k{ks} {name}: max abs "
                f"err {err:.4g}, scale {scale:.4g}, rel {err / scale:.4g} "
                f"(limit {GRAD_TOL_OF_SCALE:.4g})")
            if not math.isfinite(err) or err > GRAD_TOL_OF_SCALE * scale:
                fail(f"conv2d_mxu {strides} {name} disagrees with the "
                     f"patches lowering")


def phase_pipeline(card: str, batch: int, seed: int) -> dict:
    """The input pipeline alone: the CUDA prefetcher's batches held to the
    host stream byte for byte at the full ResNet-50 batch, then both
    stages drained without a step for ResNet-50 and Inception-v3 batches
    at 1 and 4 workers."""
    import numpy as np
    import torch

    from distributed_tensorflow_models_tpu_torch import telemetry
    from distributed_tensorflow_models_tpu_torch.data import pipeline as pipelib
    from distributed_tensorflow_models_tpu_torch.harness import train as trainlib
    from distributed_tensorflow_models_tpu_torch.harness.config import get_config

    def stack(cfg, workers, registry):
        host = pipelib.HostPipeline(trainlib.build_dataset(cfg), prefetch=4,
                                    num_workers=workers, registry=registry)
        return host, pipelib.DevicePrefetcher(host, "cuda", depth=2,
                                              registry=registry)

    # Byte equality with the consumer's stream kept busy before each read
    # and each batch dropped right after it: a missing wait_event or
    # record_stream shows as a batch that differs from the host's.
    r50 = get_config("resnet50_synthetic", global_batch_size=batch,
                     seed=seed)
    host, pf = stack(r50, 4, telemetry.MetricsRegistry())
    reads = []
    try:
        for _ in range(PIPE_CHECK_BATCHES):
            torch.cuda._sleep(PIPE_SLEEP_CYCLES)
            got = next(pf)
            reads.append({k: v * 1 for k, v in got.items()})
            del got
    finally:
        pf.stop()
        host.stop()
    torch.cuda.synchronize()
    ref = iter(trainlib.build_dataset(r50))
    for i, got in enumerate(reads):
        want = next(ref)
        for k, v in want.items():
            if not np.array_equal(got[k].cpu().numpy(), v):
                fail(f"prefetched ResNet-50 batch {i} ({k}) differs from "
                     f"the host stream")
    shapes = {k: tuple(v.shape) for k, v in reads[0].items()}
    log(f"pipeline: {len(reads)} ResNet-50 batches {shapes} through "
        f"HostPipeline(4 workers) and the CUDA DevicePrefetcher equal the "
        f"host stream byte for byte, the consumer's stream busy before each "
        f"read and each batch dropped after it")
    del reads

    arms = []
    inc = get_config("inception_v3_imagenet", global_batch_size=batch,
                     seed=seed)
    for name, cfg in (("ResNet-50", r50), ("Inception-v3", inc)):
        for workers in (1, 4):
            reg = telemetry.MetricsRegistry()
            host, pf = stack(cfg, workers, reg)
            try:
                for _ in range(PIPE_WARM_BATCHES):
                    nbytes = sum(v.nbytes for v in next(pf).values())
                torch.cuda.synchronize()
                waits = []
                t0 = time.perf_counter()
                for _ in range(PIPE_DRAIN_BATCHES):
                    t = time.perf_counter()
                    next(pf)
                    waits.append(time.perf_counter() - t)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                pinned = pf.pinned_bytes
            finally:
                pf.stop()
                host.stop()
            snap = reg.snapshot()
            waits.sort()
            arm = {
                "batches": name, "workers": workers, "batch_bytes": nbytes,
                "batches_per_s": PIPE_DRAIN_BATCHES / wall,
                "h2d_gb_per_s": PIPE_DRAIN_BATCHES * nbytes / wall / 1e9,
                "pinned_bytes": pinned,
                "next_wait_median_ms": 1e3 * waits[len(waits) // 2],
                "prefetch_fill_p50_ms":
                    1e3 * snap[f"{telemetry.PREFETCH_FILL}/p50_s"],
            }
            arms.append(arm)
            log(f"pipeline drained, {name} batches ({nbytes / 1e6:.1f} MB), "
                f"{workers} worker(s): {arm['batches_per_s']:.2f} batches/s, "
                f"{arm['h2d_gb_per_s']:.2f} GB/s host to device, pinned "
                f"{pinned / 2**20:.1f} MiB, wait in next() median "
                f"{arm['next_wait_median_ms']:.2f} ms, fill thread's wait "
                f"on the host stage p50 {arm['prefetch_fill_p50_ms']:.2f} ms "
                f"| {card}")
    log(json.dumps({"pipeline": arms}))
    return {"arms": arms}


# --parent-tree: ``fit`` of each tree in a process of its own, from the
# tree's own checkout: the config, its field overrides as JSON (the
# optimizer as a dict), the workdir; prints the run's timed window (its
# steps, seconds and examples or tokens), its last loss, the first step
# whose loss was not finite (an older fit has no NaN guard) and peak
# memory.  A tree whose
# FitResult has no ``window_s`` (an eager fit, which reads every step's
# metrics back) is timed from the end of its step AB_WINDOW_FROM to the
# end of its last step: the steps this tree's window holds, the first
# chunk of STEPS_PER_LOOP left out.
AB_WINDOW_FROM = 4
AB_RUNNER = """
import json, math, os, shutil, sys
import torch
from distributed_tensorflow_models_tpu_torch.harness import config, train
spec = json.loads(sys.argv[1])
over = dict(spec["over"])
if "optimizer" in over:
    over["optimizer"] = config.OptimizerConfig(**over["optimizer"])
r = train.fit(config.get_config(spec["config"], **over), spec["workdir"],
              device="cuda")
# A tree whose fit checkpoints saved a final step there; nothing reads it.
shutil.rmtree(os.path.join(spec["workdir"], "checkpoints"),
              ignore_errors=True)
h = r.history
if getattr(r, "window_s", None) is not None:
    window_s, window_steps = r.window_s, r.window_steps
else:
    start = spec["window_from"]
    window_s, window_steps = h[-1]["end_s"] - h[start - 1]["end_s"], len(h) - start
key = "tokens" if "tokens" in h[0] else "batch_size"
bad = [row["step"] for row in h if not math.isfinite(row["loss"])]
print(json.dumps({"steps": r.state.step, "window_s": window_s,
                  "window_steps": window_steps, "unit": key,
                  "window_count": sum(row[key] for row in h[-window_steps:]),
                  "last_loss": h[-1]["loss"],
                  "first_nonfinite": bad[0] if bad else None,
                  "peak_gib": torch.cuda.max_memory_allocated() / 2**30}))
"""


def tree_ab_arms(batch: int) -> tuple:
    """``--parent-tree``'s arms, every zoo path: label, config, field
    overrides, DTM_CONV_IMPL, DTM_CONV_MXU_PIPELINE, DTM_FLASH_BWD and the
    steps, enough that the captured step's window lasts a few seconds and
    many times the batches the input pipeline buffers.  VGG-16 and AlexNet
    read their input at one worker here (the bench's four elsewhere): at
    four, an older tree's worker pool queues batches without bound while
    its step is slower (F4), and over these steps it meets the host's
    memory limit.  AlexNet's loss is not finite from step 85 on at these
    settings, in an eager tree and a captured one alike: its arm stops
    before."""
    return (
        ("ResNet-50, K1", "resnet50_synthetic",
         {"global_batch_size": batch}, "mxu", "0", "pair", 24),
        ("Inception-v3, K6", "inception_v3_imagenet",
         {"global_batch_size": batch}, "mxu", "1", "pair", 16),
        ("ResNet-32, f32 K1", "resnet32_cifar10", {}, "mxu", "0", "pair",
         220),
        ("LeNet", "lenet_mnist", {}, "mxu", "0", "pair", 2500),
        ("VGG-16, K1", "resnet50_synthetic",
         {**bench_overrides("vgg16", 64), "data_workers": 1}, "mxu", "0",
         "pair", 60),
        ("AlexNet, K1", "resnet50_synthetic",
         {**bench_overrides("alexnet", 128), "data_workers": 1}, "mxu",
         "0", "pair", 84),
        ("transformer_lm, K2-K4", "transformer_lm", {"attn_impl": "flash"},
         "mxu", "0", "pair", 400),
        ("transformer_lm_modern, K2 + K5", "transformer_lm_modern",
         {"attn_impl": "flash"}, "mxu", "0", "staged", 400),
        ("ptb_medium", "ptb_medium", {}, "mxu", "0", "pair", 400),
    )


def phase_tree_ab(parent: Path, batch: int, card: str) -> None:
    """``fit`` of another tree (``parent``: the eager step, metrics read
    back every step) and of this one (chunks of ``STEPS_PER_LOOP``, the
    step captured and replayed) in turns (parent, this, this, parent),
    each in a process of its own, for every arm of ``tree_ab_arms``: the
    same steps, each run timed over the same steps (``AB_RUNNER``).
    Prints each run's end-to-end rate, its window's steps and
    milliseconds, and peak memory, and per arm each tree's median rate."""
    for label, config, over, impl, knob, bwd, steps in tree_ab_arms(batch):
        rates = {"parent": [], "this": []}
        windows = {"parent": [], "this": []}
        order = (("parent", parent), ("this", ROOT), ("this", ROOT),
                 ("parent", parent))
        for n, (who, tree) in enumerate(order):
            workdir = ROOT / "build" / "chip_smoke" / f"ab_{config}_{n}"
            run_over = {**over, "train_steps": steps}
            if who == "this":
                run_over["steps_per_loop"] = STEPS_PER_LOOP
            env = {**os.environ, "PYTHONPATH": str(tree),
                   "DTM_CONV_IMPL": impl, "DTM_CONV_MXU_PIPELINE": knob,
                   "DTM_FLASH_BWD": bwd}
            spec = json.dumps({"config": config, "over": run_over,
                               "workdir": str(workdir),
                               "window_from": AB_WINDOW_FROM})
            out = subprocess.run([sys.executable, "-c", AB_RUNNER, spec],
                                 cwd=tree, env=env, capture_output=True,
                                 text=True, timeout=900)
            if out.returncode != 0:
                fail(f"{who} tree's {label} run exited {out.returncode}: "
                     f"{out.stderr[-2000:]}")
            result = json.loads(out.stdout.strip().splitlines()[-1])
            if result["steps"] != steps:
                fail(f"{who} tree's {label} run took {result['steps']} steps")
            if result["window_steps"] != steps - AB_WINDOW_FROM:
                fail(f"{who} tree's {label} run timed "
                     f"{result['window_steps']} steps, not the "
                     f"{steps - AB_WINDOW_FROM} after its first chunk")
            unit = ("tokens/s" if result["unit"] == "tokens"
                    else "images/s")
            rate = result["window_count"] / result["window_s"]
            window = (f"{result['window_steps']} steps in "
                      f"{result['window_s'] * 1e3:.1f} ms")
            rates[who].append(rate)
            windows[who].append(window)
            log(f"trees in turns, {label} ({who}): {rate:.1f} {unit} end "
                f"to end over {window}; last loss {result['last_loss']!r}, "
                f"first non-finite loss at step {result['first_nonfinite']}; "
                f"peak memory {result['peak_gib']:.3f} GiB | {card}")
        med = {k: sorted(v)[len(v) // 2] for k, v in rates.items()}
        log(f"trees in turns, {label}: {len(order)} runs, median {unit} "
            f"parent {med['parent']:.1f} ({'; '.join(windows['parent'])}), "
            f"this {med['this']:.1f} ({'; '.join(windows['this'])}) "
            f"({med['this'] / med['parent']:.3f}x); every run of this above "
            f"every parent run: {min(rates['this']) > max(rates['parent'])}, "
            f"below: {max(rates['this']) < min(rates['parent'])} | {card}")


def replay_paths(batch: int) -> tuple:
    """Phase 3c's paths, every zoo path at full width: label, config,
    DTM_CONV_IMPL, DTM_CONV_MXU_PIPELINE, DTM_FLASH_BWD, whether the step
    is free of atomics (then the replays must equal the eager steps bit
    for bit), and the steps."""
    short, ahead = REPLAY_STEPS, REPLAY_STEPS_AHEAD
    return (
        ("ResNet-50 (K1)", named_config(
            "resnet50_synthetic", {"global_batch_size": batch}),
         "mxu", "0", "pair", True, short),
        ("Inception-v3 (K6)", named_config(
            "inception_v3_imagenet", {"global_batch_size": batch}),
         "mxu", "1", "pair", True, short),
        ("ResNet-32 (f32 K1)", named_config("resnet32_cifar10", {}),
         "mxu", "0", "pair", True, ahead),
        ("VGG-16 (K1)", bench_config("vgg16", 64, short),
         "mxu", "0", "pair", True, short),
        ("AlexNet (K1)", bench_config("alexnet", 128, short),
         "mxu", "0", "pair", True, short),
        ("LeNet", named_config("lenet_mnist", {}), "mxu", "0", "pair", True,
         ahead),
        ("transformer_lm (K2-K4)", named_config(
            "transformer_lm", {"attn_impl": "flash"}),
         "mxu", "0", "pair", False, ahead),
        ("transformer_lm_modern (K2, K5)", named_config(
            "transformer_lm_modern", {"attn_impl": "flash"}),
         "mxu", "0", "staged", False, ahead),
        ("ptb_medium", named_config("ptb_medium", {}), "mxu", "0", "pair",
         False, ahead),
    )


def state_tensors(state) -> list:
    """Every tensor of a train state: parameters, BN statistics, optimizer
    slots and counts, EMA shadows, the carry and the device step."""
    from distributed_tensorflow_models_tpu_torch.core import train_loop

    return [t.detach() for t in train_loop._leaves((
        state.params, state.batch_stats, state.opt_state, state.ema_params,
        state.carry, state.device_step))]


def rel_l2(a, b) -> float:
    import torch

    a, b = a.double().flatten(), b.double().flatten()
    den = float(torch.linalg.vector_norm(b))
    num = float(torch.linalg.vector_norm(a - b))
    return num / den if den else num


def phase_replay(batch: int, card: str) -> None:
    """Replay against eager on every zoo path at full width, the run-ahead
    included: the path's steps (:func:`replay_paths`) of ``fit`` in chunks
    of ``STEPS_PER_LOOP`` (the first step eager, the rest replays of the
    captured step, a shorter tail chunk on the same graph), its batches
    through ``HostPipeline``, the ``DevicePrefetcher`` and the
    ``BatchStacker``, on the short-step paths with chunks dispatched while
    earlier ones still run (``FitResult.chunks_in_flight``, printed; the
    phase fails if that happened on no path), against the eager step on
    the dataset's own stream read serially, from the same seeded state.  Where the step has no atomics every loss and every
    state tensor must be equal bit for bit: the replays then consumed the
    host stream's batches, in order, and read each step's rate, decay and
    dropout bits.  The LM paths' embedding gradient adds rows with atomics
    (``index_add_``), which reorder f32 sums in every run, eager or not:
    their losses are held to 1e-5 relative and their state, over all
    tensors, to 1e-4 in relative L2 (a stale rate, stale dropout bits or a
    stale batch moves them by 1e-3 or more)."""
    import itertools

    import torch

    from distributed_tensorflow_models_tpu_torch.harness import train as trainlib
    from distributed_tensorflow_models_tpu_torch.ops import conv as convlib

    dev = torch.device("cuda")
    ahead = []
    for label, cfg, impl, knob, bwd, exact, steps in replay_paths(batch):
        convlib.set_default_conv_impl(impl)
        os.environ["DTM_CONV_MXU_PIPELINE"] = knob
        os.environ["DTM_FLASH_BWD"] = bwd
        cfg = cfg.replace(train_steps=steps, steps_per_loop=STEPS_PER_LOOP)
        state = trainlib.build_state(cfg, dev)
        step = trainlib.build_step(cfg, state)
        want = []
        for b in itertools.islice(iter(trainlib.build_dataset(cfg)), steps):
            state, metrics = step(state, {k: torch.from_numpy(v).to(dev)
                                          for k, v in b.items()}, cfg.seed)
            want.append(float(metrics["loss"]))
        eager = [t.clone() for t in state_tensors(state)]
        del state, step
        r = trainlib.fit(cfg, device="cuda")
        got = [row["loss"] for row in r.history]
        replayed = state_tensors(r.state)
        if r.chunks_in_flight > 1:
            ahead.append(label)
        if (r.captures, r.replayed_steps) != (1, steps - 1):
            fail(f"replay vs eager, {label}: {r.captures} captures, "
                 f"{r.replayed_steps} replayed steps")
        if len(replayed) != len(eager):
            fail(f"replay vs eager, {label}: the states differ in layout")
        same = sum(bool(torch.equal(a, b)) for a, b in zip(replayed, eager))
        floats = [(a.float(), b.float()) for a, b in zip(replayed, eager)
                  if a.is_floating_point()]
        total = rel_l2(torch.cat([a.flatten() for a, _ in floats]),
                       torch.cat([b.flatten() for _, b in floats]))
        loss_rel = max(abs(x - y) / abs(y) for x, y in zip(got, want))
        log(f"replay vs eager, {label}: {steps} steps (chunks of "
            f"{STEPS_PER_LOOP}, then the tail; at most {r.chunks_in_flight} "
            f"chunks in flight); losses {got}; largest loss "
            f"difference {loss_rel:.3g} relative; {same} of {len(eager)} "
            f"state tensors equal bit for bit, state rel L2 {total:.3g} "
            f"({'bit for bit required' if exact else 'bounded: atomics'}) "
            f"| {card}")
        if exact and (got != want or same != len(eager)):
            fail(f"replay vs eager, {label}: the replayed steps differ from "
                 f"the eager ones")
        if not exact and (loss_rel > 1e-5 or total > 1e-4):
            fail(f"replay vs eager, {label}: loss {loss_rel:.3g} relative, "
                 f"state {total:.3g} in relative L2, over 1e-5 and 1e-4")
        del r, replayed, eager
    if not ahead:
        fail("replay vs eager: on no path did the host dispatch a chunk "
             "while the device still ran an earlier one")
    log(f"replay vs eager: the host ran chunks ahead of the device on "
        f"{', '.join(ahead)}")
    convlib.set_default_conv_impl("mxu")
    os.environ["DTM_CONV_MXU_PIPELINE"] = "0"
    os.environ["DTM_FLASH_BWD"] = "pair"


def run_cli_train(config: str, steps: int, batch: int,
                  workdir: Path) -> dict:
    """The CLI's ``train`` in this process at ``STEPS_PER_LOOP``; returns
    its JSON line, which must show one capture and every step after the
    first replayed."""
    from distributed_tensorflow_models_tpu_torch.harness import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["train", "--config", config, "--workdir",
                       str(workdir), "--train-steps", str(steps),
                       "--batch-size", str(batch), "--steps-per-loop",
                       str(STEPS_PER_LOOP), "--device", "cuda"])
    if rc != 0:
        fail(f"cli train exited {rc}")
    shutil.rmtree(workdir / "checkpoints", ignore_errors=True)
    result = json.loads(buf.getvalue().strip().splitlines()[-1])
    if (result["steps"], result["captures"], result["replayed_steps"]) != (
            steps, 1, steps - 1):
        fail(f"cli train: {result}")
    return result


def run_named(config: str, steps: int, batch: int, workdir: Path,
              **over) -> dict:
    """``fit`` of the named config (the CLI's ``train --config``, in this
    process) at ``batch`` for ``steps`` steps, with ``over`` replacing
    config fields; summarised as ``run_fit`` does."""
    from distributed_tensorflow_models_tpu_torch.harness.config import get_config

    return run_fit(get_config(config, train_steps=steps,
                              global_batch_size=batch, **over), workdir)


def run_fit(cfg, workdir: Path, mesh=None, keep: bool = False) -> dict:
    """``fit`` in this process on the card in chunks of
    ``STEPS_PER_LOOP`` (on ``mesh``, by default the config's): the CLI's
    JSON fields from its result, how its steps ran and its timed window,
    summarised by ``summarize_run`` (with the ``FitResult`` under
    ``"fit"`` if ``keep``).  Fails unless the step was captured once and
    every step after the first replayed (no step ran eagerly in its
    place)."""
    import torch

    from distributed_tensorflow_models_tpu_torch.harness import train as trainlib

    cfg = cfg.replace(steps_per_loop=STEPS_PER_LOOP)
    # An earlier arm's graph pool stays reserved until the allocator's
    # cache is emptied: empty it, so that the peak reserved is this arm's.
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    r = trainlib.fit(cfg, str(workdir), device="cuda", mesh=mesh)
    # fit saved a final checkpoint there; no later arm reads it.
    shutil.rmtree(workdir / "checkpoints", ignore_errors=True)
    result = {"final_metrics": r.final_metrics, "steps": r.state.step,
              "device": r.device,
              "steady_step_time_s": r.steady_step_time_s,
              "images_per_sec": r.images_per_sec,
              "tokens_per_sec": r.tokens_per_sec,
              "captures": r.captures, "capture_s": r.capture_s,
              "replayed_steps": r.replayed_steps, "window_s": r.window_s,
              "window_steps": r.window_steps,
              "window_data_s": r.window_data_s,
              "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
              "peak_reserved_gib": torch.cuda.max_memory_reserved() / 2**30}
    if (r.captures, r.replayed_steps) != (1, cfg.train_steps - 1):
        fail(f"{cfg.name}: {r.captures} captures and {r.replayed_steps} "
             f"replayed steps of {cfg.train_steps}: every step after the "
             f"first must replay the one captured step")
    if keep:
        result["fit"] = r
    return summarize_run(result, r.history, cfg.train_steps)


def summarize_run(result: dict, rows: list, steps: int) -> dict:
    """Check a run's length and losses and add its losses and mean and
    median wait for input to ``result``."""
    if result["steps"] != steps or len(rows) != steps:
        fail(f"trained {result['steps']} steps ({len(rows)} rows), "
             f"asked for {steps}")
    losses = [r["loss"] for r in rows]
    if not all(math.isfinite(v) for v in losses):
        fail(f"non-finite loss: {losses}")
    result["losses"] = losses
    steady = rows[STEPS_PER_LOOP:] or rows
    waits = sorted(r["data_s"] for r in steady)
    result["data_s"] = sum(waits) / len(waits)
    result["median_data_s"] = waits[len(waits) // 2]
    return result


def graph_ms(fn, iters: int = 20, replays: int = 5) -> float:
    """Mean device time of ``fn`` with the host's launch cost taken out:
    ``iters`` calls captured in a CUDA graph, the graph replayed
    ``replays`` times between CUDA events.  (Events over back-to-back
    eager calls time the host once it is slower than the card; at the LM
    shape it is.)"""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / (iters * replays)


def _kernel_class(name: str) -> str:
    low = name.lower()
    if "nccl" in low or "onerankreduce" in low:
        return NCCL_CLASS
    if "conv_implicit_gemm_pipelined" in low:
        return "K6"
    if "conv_implicit_gemm" in low:
        return "K1"
    if "dtm_flash_dkv" in low and "true" in low:
        return "K5 dKV"
    for kid, marker in (("K5 dQ", "dtm_flash_dq_staged"),
                        ("K2", "dtm_flash_fwd"), ("K3", "dtm_flash_dkv"),
                        ("K4", "dtm_flash_dq")):
        if marker in low:
            return kid
    # cuDNN's conv kernels are implicit GEMMs too: match them first.
    if any(s in low for s in ("fprop", "dgrad", "wgrad", "conv", "cudnn")):
        return "cuDNN conv"
    if any(s in low for s in ("gemm", "nvjet", "xmma", "cutlass", "cublas")):
        return "cuBLAS matmul"
    if "reduce" in low:
        return "reductions"
    if any(s in low for s in ("copy", "cat", "pad", "fill", "memset",
                              "memcpy", "index", "slice")):
        return COPY_CLASS
    return "elementwise and other"


COPY_CLASS = "copies, pads, fills"
NCCL_CLASS = "NCCL collectives"


# Traces a profile may take before its phase fails.  The profiler drops
# device records of a large graph's replay now and then (Inception-v3:
# ~12,100 events a replay; six traces of three replays in a row lost some
# in one smoke run, always in the third, and a trace of two once in the
# second): a trace holds two replays, and one that lost records is never
# used, only retaken.
PROFILE_ATTEMPTS = 6


def _timed_trace(prof) -> tuple[list, list, int]:
    """The device events of ``prof`` caused by the host's CUDA calls after
    the first ``cudaDeviceSynchronize`` that follows its first graph
    launch (the warm-up replay), as (name, ns, correlation id).
    CUDA calls are numbered in the order the host makes them, and each
    device event carries its call's number (a replayed kernel its
    ``cudaGraphLaunch``'s): the timestamps of host calls and of host ranges
    come from two clocks and do not place a call in a range.  Also those
    graph launches' events, counted by name, in launch order; and the
    number of those NCCL kernels that no graph launch issued."""
    import torch

    cpu = torch.autograd.DeviceType.CPU
    events = prof.profiler.kineto_results.events()
    calls = collections.defaultdict(list)
    for e in events:
        if e.device_type() == cpu and e.correlation_id() > 0:
            calls[e.name()].append(e.correlation_id())
    warm = min(calls["cudaGraphLaunch"], default=None)
    mark = min((c for c in calls["cudaDeviceSynchronize"]
                if warm is not None and c > warm), default=None)
    if mark is None:
        fail(f"profile: no cudaDeviceSynchronize after a graph launch in "
             f"the trace (launches {sorted(calls['cudaGraphLaunch'])}, "
             f"syncs {sorted(calls['cudaDeviceSynchronize'])})")
    launches = sorted(c for c in calls["cudaGraphLaunch"] if c > mark)
    timed = [(e.name(), e.duration_ns(), e.correlation_id()) for e in events
             if e.device_type() != cpu and e.correlation_id() > mark]
    per_launch = {c: collections.Counter() for c in launches}
    loose_nccl = 0
    for name, _, corr in timed:
        if corr in per_launch:
            per_launch[corr][name] += 1
        elif _kernel_class(name) == NCCL_CLASS:
            loose_nccl += 1
    return timed, list(per_launch.values()), loose_nccl


def phase_profile(cfg, arm: str, steps: int = 2, mesh=None) -> dict:
    """Device time of the training step by kernel class, and the device's
    idle share, over ``steps`` replays of the captured step (the K-step
    call, as ``fit`` runs it), after a chunk of two that runs the first
    step eagerly, captures it and replays it once (the batches are on the
    card beforehand), with the conv lowering set as it is; under
    ``mesh``'s data axis if given, its state placed as ``fit`` places it.
    Each trace holds one timed replay, after one more replay that starts
    it and a device sync that starts the timed part; that first replay is
    left out: the first replay traced can lose device records (seen in
    the smoke's world-1 NCCL profile, three traces in a row, while the
    second replay lost none), and so can a third (Inception-v3's).

    Every replay runs the same graph, so complete traces hold the same
    kernels under their timed graph launch.  Traces are taken until
    ``steps`` of them agree, up to ``PROFILE_ATTEMPTS`` in all; one that
    differs lost device records (the profiler's, not the card's) and is
    never used; the phase fails if no ``steps`` traces agree.  Returns
    the kernels of the agreeing traces, (ms a step, launches a step,
    name), under ``"kernels"``; each timed replay's device events by name
    under ``"replays"``; and the NCCL kernels that no replay issued under
    ``"loose_nccl"``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from distributed_tensorflow_models_tpu_torch.core import mesh as meshlib
    from distributed_tensorflow_models_tpu_torch.core import train_loop
    from distributed_tensorflow_models_tpu_torch.harness import train as trainlib

    # Room in the schedule tables for every trace this phase may take.
    cfg = cfg.replace(train_steps=max(cfg.train_steps,
                                      2 + 2 * PROFILE_ATTEMPTS))
    batch = cfg.global_batch_size
    dev = torch.device("cuda")
    state = trainlib.build_state(cfg, dev)
    if mesh is not None:
        state = train_loop.place_state(state, mesh)
    multi = train_loop.MultiStep(trainlib.build_step(cfg, state),
                                 name=cfg.model)
    batches = iter(trainlib.build_dataset(cfg))
    on_card = [{k: torch.from_numpy(v).to(dev) for k, v in
                next(batches).items()} for _ in range(4)]

    def chunk(rows):
        return {k: torch.stack([b[k] for b in rows]) for k in rows[0]}

    with meshlib.data_parallel(mesh):
        state, rows = multi(state, chunk(on_card[:2]), cfg.seed)
    warm, timed = chunk(on_card[2:3]), chunk(on_card[3:4])
    float(rows["loss"][-1])
    traces = []  # (events, the timed replay's events by name, loose, ms)
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            with meshlib.data_parallel(mesh):
                state, rows = multi(state, warm, cfg.seed)
            float(rows["loss"][-1])
            torch.cuda.synchronize()  # the timed part's start, for the trace
            t0 = time.perf_counter()
            with meshlib.data_parallel(mesh):
                state, rows = multi(state, timed, cfg.seed)
            float(rows["loss"][-1])
            wall_ms = (time.perf_counter() - t0) * 1e3
        events, replays, loose_nccl = _timed_trace(prof)
        if len(replays) != 1:
            fail(f"profile ({arm}): trace {attempt} holds {len(replays)} "
                 f"timed graph launches, expected 1")
        traces.append((events, replays[0], loose_nccl, wall_ms))
        agree = [t for t in traces if t[1] == replays[0]]
        if len(agree) == steps:
            break
        if len(traces) > 1:
            log(f"profile ({arm}): trace {attempt}'s replay holds "
                f"{sum(replays[0].values())} device events, the earlier "
                f"traces' {[sum(t[1].values()) for t in traces[:-1]]}: the "
                f"profiler lost records in one of them, so another replay "
                f"is profiled")
    else:
        fail(f"profile ({arm}): no {steps} traces of {PROFILE_ATTEMPTS} "
             f"agree")
    if multi.captures != 1 or multi.replays != 2 * attempt + 1:
        fail(f"profile ({arm}): {multi.captures} captures, {multi.replays} "
             f"replays, expected 1 and {2 * attempt + 1}")
    events = [e for t in agree for e in t[0]]
    replays = [t[1] for t in agree]
    loose_nccl = sum(t[2] for t in agree)
    wall_ms = sum(t[3] for t in agree) / steps
    # Device-side events only: a CPU op's self device time repeats the
    # time of the kernels it launched.
    by_name = collections.defaultdict(lambda: [0, 0])
    for name, ns, _ in events:
        by_name[name][0] += ns
        by_name[name][1] += 1
    kernels = [(ns / 1e6 / steps, n // steps, name)
               for name, (ns, n) in by_name.items() if ns > 0]
    busy_ms = sum(ms for ms, _, _ in kernels)
    if busy_ms == 0:
        fail(f"profile ({arm}): the profiler saw no device time")
    if not 0.0 <= 1 - busy_ms / wall_ms <= 1.0:
        fail(f"profile ({arm}): device busy {busy_ms:.2f} ms exceeds the "
             f"wall {wall_ms:.2f} ms: kernels are counted more than once")
    classes = collections.Counter()
    for ms, _, name in kernels:
        classes[_kernel_class(name)] += ms
    log(f"profile ({arm}, replayed step), per step at batch {batch}: wall "
        f"{wall_ms:.2f} ms (profiler on), device busy {busy_ms:.2f} ms, "
        f"idle share {1 - busy_ms / wall_ms:.3f}")
    for cls, ms in classes.most_common():
        log(f"  {cls:>22}: {ms:8.2f} ms  {ms / busy_ms:6.1%} of busy")
    for ms, count, name in sorted(kernels, reverse=True)[:12]:
        log(f"  {ms:8.3f} ms x{count:<4d} {name[:110]}")
    return {"kernels": kernels, "replays": replays, "loose_nccl": loose_nccl}


GROUP_ARM = "NCCL group"


def phase_data_parallel(batch: int, steps: int, k1_per_step: int, card: str,
                        workdir: Path) -> dict:
    """The ResNet-50 path (K1 on every 3x3 conv) as one process of a world-1
    NCCL group, joined through the port's ``launch.initialize_from_env``
    from ``DTM_*`` variables set here (127.0.0.1, a free port, 1 process,
    id 0), after ``fit`` without a group (no group, group), each timed
    over the steps after the first chunk.  Fails unless the grouped arm's
    losses and state tensors equal the first arm's bit for bit; the collective counters show, per
    step of each grouped arm (every step after the first a replay), the
    gradient bucket, each BatchNorm layer's moments and their cotangents
    and the metric vector once (and the two startup checks), and none in
    the arms without a group; K1 launches ``k1_per_step`` a step in every
    arm; and a profile of two replays in the group sees, under each
    replay's graph launch, one NCCL kernel per collective, and no NCCL
    kernel outside the replays.  The group is destroyed at the end,
    whatever happens."""
    import socket

    import torch
    import torch.distributed as dist

    from distributed_tensorflow_models_tpu_torch import launch
    from distributed_tensorflow_models_tpu_torch.core import mesh as meshlib
    from distributed_tensorflow_models_tpu_torch.core import sharding
    from distributed_tensorflow_models_tpu_torch.harness import train as trainlib
    from distributed_tensorflow_models_tpu_torch.harness.config import get_config
    from distributed_tensorflow_models_tpu_torch.ops import conv_mxu
    from distributed_tensorflow_models_tpu_torch.ops.normalization import BatchNorm

    k1 = conv_mxu.conv_implicit_gemm
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = {launch.ENV_COORDINATOR: f"127.0.0.1:{port}",
           launch.ENV_NUM_PROCESSES: "1", launch.ENV_PROCESS_ID: "0"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        t0 = time.perf_counter()
        if not launch.initialize_from_env():
            fail("data parallel: initialize_from_env found no cluster")
        init_s = time.perf_counter() - t0
        try:
            cfg = get_config("resnet50_synthetic", global_batch_size=batch,
                             train_steps=steps)
            group = trainlib.mesh_from_config(cfg)
            if (group.world_size, group.backend) != (1, "nccl"):
                fail(f"data parallel: a world of {group.world_size} over "
                     f"{group.backend}, expected 1 over nccl")
            alone = meshlib.local_mesh("cuda")
            arms = []
            for label, mesh in (("no group", alone), (GROUP_ARM, group)):
                zero_counts((k1,))
                before = sharding.collective_counts()
                r = run_fit(cfg, workdir / f"dp{len(arms)}", mesh=mesh,
                            keep=True)
                r["collectives"] = sharding.counts_since(before)
                r["k1"] = k1.launches
                state = r.pop("fit").state
                if not arms:
                    bn = sum(isinstance(m, BatchNorm)
                             for m in state.model.modules())
                if len(arms) < 2:
                    # On the host, so that no arm's peak holds another's.
                    r["state"] = [t.cpu() for t in state_tensors(state)]
                del state
                arms.append((label, r))
            want = {"replica_check": 2, "grads": steps, "metrics": steps,
                    "bn_moments": bn * steps, "bn_moments_grad": bn * steps}
            per_step = sum(n for site, n in want.items()
                           if site != "replica_check") // steps
            for label, r in arms:
                counts = {site: n for site, (n, _) in r["collectives"].items()}
                expected = want if label == GROUP_ARM else {}
                if counts != expected:
                    fail(f"data parallel, {label}: collectives {counts}, "
                         f"expected {expected}")
                if r["k1"] != k1_per_step * steps:
                    fail(f"data parallel, {label}: K1 launched {r['k1']} "
                         f"times, expected {k1_per_step * steps}")
                if r["losses"] != arms[0][1]["losses"]:
                    fail(f"data parallel, {label}: losses {r['losses']} "
                         f"differ from {arms[0][1]['losses']}")
            a, b = arms[1][1].pop("state"), arms[0][1].pop("state")
            same = sum(bool(torch.equal(x, y)) for x, y in zip(a, b))
            if len(a) != len(b) or same != len(a):
                fail(f"data parallel: {same} of {len(a)} state tensors of "
                     f"the grouped fit equal the fit without a group")
            nbytes = {site: b for site, (_, b) in
                      arms[1][1]["collectives"].items()}
            log(f"data parallel: world-1 NCCL group joined in "
                f"{init_s:.2f} s; ResNet-50 at batch {batch}, {steps} steps "
                f"in chunks of {STEPS_PER_LOOP}: losses and all {len(a)} "
                f"state tensors equal the fit without a group bit for bit; "
                f"collectives a step: {per_step} (1 gradient bucket of "
                f"{nbytes['grads'] // steps} bytes, {bn} BatchNorm moments "
                f"and {bn} cotangents of {nbytes['bn_moments'] // steps} "
                f"bytes in all, 1 metric vector); K1 {k1_per_step} a step "
                f"| {card}")
            del a, b
            for label, r in arms:
                log_arm(f"ResNet-50 {label}", r, batch, card)
            prof = phase_profile(
                cfg, "ResNet-50, K1 convs, world-1 NCCL group", mesh=group)
            nccl = [(ms, name) for ms, _, name in prof["kernels"]
                    if _kernel_class(name) == NCCL_CLASS]
            nccl_ms = sum(ms for ms, _ in nccl)
            per_replay = [sum(n for name, n in r.items()
                              if _kernel_class(name) == NCCL_CLASS)
                          for r in prof["replays"]]
            names = ", ".join(sorted({name[:60] for _, name in nccl}))
            log(f"data parallel: NCCL kernels inside each profiled replay "
                f"(by its graph launch): {per_replay} ({names}), "
                f"{prof['loose_nccl']} outside them, {nccl_ms:.4f} ms of "
                f"device time a step | {card}")
            if prof["loose_nccl"]:
                fail(f"data parallel: the profile saw {prof['loose_nccl']} "
                     f"NCCL kernels launched outside the replays")
            if any(n != per_step for n in per_replay):
                fail(f"data parallel: the profiled replays ran {per_replay} "
                     f"NCCL kernels, expected {per_step} in each")
        finally:
            dist.destroy_process_group()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return {"arms": arms, "per_step": per_step, "nccl_ms": nccl_ms}


# Phase 5c: ResNet-50 runs of RESUME_STEPS steps; the resumed run stops
# at RESUME_AT first.  A save every CKPT_EVERY steps in the cost arms.
RESUME_STEPS = 12
RESUME_AT = 8
CKPT_EVERY = 4


class PoisonAt:
    """A dataset whose batch at one position (the one after which its
    cursor reads ``after``) has every image value set to NaN: a poisoned
    batch that a rollback's replay meets again at the same position."""

    def __init__(self, ds, after: dict):
        self._ds, self._after = ds, after

    def __iter__(self):
        import numpy as np

        for batch in self._ds:
            if self._ds.get_state() == self._after:
                batch = dict(batch)
                batch["image"] = np.full_like(batch["image"], np.nan)
            yield batch

    def get_state(self):
        return self._ds.get_state()

    def set_state(self, state):
        self._ds.set_state(state)


class DropBatches:
    """A dataset without the batches at some positions (those after which
    its cursor reads one of ``after``): the batches a rollback skips."""

    def __init__(self, ds, after: list):
        self._ds, self._after = ds, after

    def __iter__(self):
        for batch in self._ds:
            if self._ds.get_state() not in self._after:
                yield batch

    def get_state(self):
        return self._ds.get_state()

    def set_state(self, state):
        self._ds.set_state(state)


def _fit_once(cfg, workdir, label: str, **kw):
    """``fit`` on the card in chunks of ``STEPS_PER_LOOP``; fails unless
    the step was captured once."""
    import torch

    from distributed_tensorflow_models_tpu_torch.harness import train as trainlib

    torch.cuda.empty_cache()
    r = trainlib.fit(cfg.replace(steps_per_loop=STEPS_PER_LOOP),
                     None if workdir is None else str(workdir),
                     device="cuda", **kw)
    if r.captures != 1:
        fail(f"fit ({label}): {r.captures} captures, expected 1")
    return r


def _state_diff(a, b) -> list:
    """Names of the state tensors that differ between two states (any
    name, shape, dtype or bit)."""
    import torch

    from distributed_tensorflow_models_tpu_torch.harness import checkpoint

    ta, pa = checkpoint.flatten_state(a)
    tb, pb = checkpoint.flatten_state(b)
    if sorted(ta) != sorted(tb) or pa != pb:
        return ["<names>"]
    return [k for k in ta if not torch.equal(ta[k], tb[k])]


def phase_resume(batch: int, card: str, workdir: Path) -> dict:
    """Checkpoint/resume on the ResNet-50 path at full width (batch
    ``batch``, K1 on every 3x3 conv, chunks of ``STEPS_PER_LOOP``), each
    ``fit`` capturing the step once, in a workdir emptied first:

    (a) ``RESUME_STEPS`` steps straight, against ``RESUME_AT`` steps (a
        final checkpoint) and a second ``fit`` to ``RESUME_STEPS`` from
        it: every state tensor and the losses of the resumed steps equal
        bit for bit (replay equals eager bit for bit on this path, so the
        resumed run's eager first step changes nothing);
    (b) the newest step (``RESUME_STEPS``) torn, its ``state.pt``
        truncated: the next ``fit`` walks back to ``RESUME_AT`` and ends
        bit-identical again;
    (c) ``nan_policy="rollback"``, a checkpoint every ``CKPT_EVERY``
        steps, batch 6 poisoned (NaN images): exactly its chunk (steps
        5-8) is skipped, one rollback, and the run ends with one capture
        (the restore went into the tensors the graph replays) equal bit
        for bit, every state tensor and every loss, to a straight ``fit``
        over the dataset without batches 5-8;
    (d) the save's cost: the same run with a save every ``CKPT_EVERY``
        steps (``keep_checkpoints`` 2) after one with no workdir (none,
        save): each save's snapshot and write seconds and
        bytes, ``checkpoint/fence`` and ``checkpoint/save``, images/s over
        the timed window.  Recorded only.

    Nothing here is caught: any mismatch fails the run."""
    from distributed_tensorflow_models_tpu_torch import telemetry
    from distributed_tensorflow_models_tpu_torch.harness import train as trainlib
    from distributed_tensorflow_models_tpu_torch.harness.config import get_config

    shutil.rmtree(workdir, ignore_errors=True)
    cfg = get_config("resnet50_synthetic", global_batch_size=batch,
                     train_steps=RESUME_STEPS, log_every_steps=STEPS_PER_LOOP,
                     checkpoint_every_secs=None, keep_checkpoints=2)
    out = {}
    # (a)
    straight = _fit_once(cfg, None, "straight")
    want_losses = [h["loss"] for h in straight.history]
    first = _fit_once(cfg.replace(train_steps=RESUME_AT), workdir / "a",
                      f"first {RESUME_AT} steps")
    if [h["loss"] for h in first.history] != want_losses[:RESUME_AT]:
        fail("resume phase (a): the first run's losses differ from the "
             "straight run's")
    del first
    resumed = _fit_once(cfg, workdir / "a", "resumed")
    diff = _state_diff(resumed.state, straight.state)
    losses = [h["loss"] for h in resumed.history]
    if (resumed.restored_from != RESUME_AT or diff
            or losses != want_losses[RESUME_AT:]):
        fail(f"resume phase (a): restored from {resumed.restored_from}, "
             f"{len(diff)} state tensors differ ({diff[:3]}), losses "
             f"{losses} against {want_losses[RESUME_AT:]}")
    n_tensors = len(trainlib.ckptlib.flatten_state(straight.state)[0])
    log(f"resume (a): {RESUME_STEPS} steps straight = {RESUME_AT} steps, "
        f"checkpoint, a new fit to {RESUME_STEPS}: all {n_tensors} state "
        f"tensors and the losses of steps {RESUME_AT + 1}-{RESUME_STEPS} "
        f"equal bit for bit; each fit captured once | {card}")
    del resumed
    # (b)
    newest = workdir / "a" / "checkpoints" / str(RESUME_STEPS)
    with open(newest / "state.pt", "r+b") as f:
        f.truncate(4096)
    walked = _fit_once(cfg, workdir / "a", "walk-back")
    diff = _state_diff(walked.state, straight.state)
    if walked.restored_from != RESUME_AT or diff:
        fail(f"resume phase (b): restored from {walked.restored_from} "
             f"past the torn step {RESUME_STEPS}, {len(diff)} state tensors "
             f"differ")
    log(f"resume (b): step {RESUME_STEPS} torn (state.pt cut to 4096 "
        f"bytes): walked back to {RESUME_AT}, ended bit-identical | {card}")
    del walked, straight
    # (c)
    probe = trainlib.build_dataset(cfg)
    it = iter(probe)
    after = []
    for _ in range(RESUME_STEPS + STEPS_PER_LOOP):
        next(it)
        after.append(probe.get_state())
    want_cursor = after[-1]
    skipped_after = after[STEPS_PER_LOOP:2 * STEPS_PER_LOOP]  # batches 5-8
    del probe, it
    build = trainlib.build_dataset

    def fit_over(wrap, run_cfg, wd, label):
        trainlib.build_dataset = lambda c, split="train", mesh=None: wrap(
            build(c, split, mesh))
        try:
            return _fit_once(run_cfg, wd, label)
        finally:
            trainlib.build_dataset = build

    rolled = fit_over(lambda ds: PoisonAt(ds, after[5]),
                      cfg.replace(nan_policy="rollback",
                                  checkpoint_every_steps=CKPT_EVERY),
                      workdir / "c", "rollback")
    rows = rolled.history
    cursor = json.loads((workdir / "c" / "checkpoints" / str(RESUME_STEPS)
                         / "data.json").read_text())["dataset"]
    if ((rolled.rollbacks, rolled.skipped_batches) != (1, STEPS_PER_LOOP)
            or [h["step"] for h in rows] != list(range(1, RESUME_STEPS + 1))
            or not all(math.isfinite(h["loss"]) for h in rows)
            or not trainlib.train_loop.state_is_finite(rolled.state)
            or cursor != want_cursor):
        fail(f"resume phase (c): {rolled.rollbacks} rollbacks, "
             f"{rolled.skipped_batches} batches skipped, steps "
             f"{[h['step'] for h in rows]}, losses {[h['loss'] for h in rows]}"
             f", cursor {cursor} (expected {want_cursor})")
    without = fit_over(lambda ds: DropBatches(ds, skipped_after), cfg, None,
                       "straight without batches 5-8")
    diff = _state_diff(rolled.state, without.state)
    losses = [h["loss"] for h in rows]
    want = [h["loss"] for h in without.history]
    if diff or losses != want:
        fail(f"resume phase (c): the rolled-back run differs from a straight "
             f"run without batches 5-8: {len(diff)} state tensors "
             f"({diff[:3]}), losses {losses} against {want}")
    log(f"resume (c): batch 6 poisoned: 1 rollback to step {CKPT_EVERY}, the "
        f"{STEPS_PER_LOOP} batches of steps 5-8 skipped, {RESUME_STEPS} "
        f"finite steps, cursor {cursor}, 1 capture ({rolled.replayed_steps} "
        f"steps replayed); every state tensor and loss equal bit for bit to "
        f"a straight fit without batches 5-8 | {card}")
    del rolled, without
    # (d)
    arms = []
    for label in ("none", "save"):
        wd = None if label == "none" else workdir / f"d{len(arms)}"
        run = cfg.replace(checkpoint_every_steps=CKPT_EVERY)
        r = _fit_once(run, wd, f"cost arm {label}")
        snap = r.registry.snapshot()
        arm = {"label": label, "images_per_sec": r.images_per_sec,
               "window_steps": r.window_steps, "window_s": r.window_s,
               "saves": r.saves,
               "fence_count": snap.get(f"{telemetry.CKPT_FENCE}/count", 0),
               "fence_s": snap.get(f"{telemetry.CKPT_FENCE}/total_s", 0.0),
               "save_span_s": snap.get(f"{telemetry.CKPT_SAVE}/total_s",
                                       0.0)}
        arms.append(arm)
        saves = [(e["step"], round(e["snapshot_s"], 4),
                  round(e["write_s"], 4), e["bytes"]) for e in r.saves]
        log(f"resume (d) arm {label}: {r.images_per_sec:.1f} images/s over "
            f"{r.window_steps} steps ({r.window_s * 1e3:.1f} ms); saves "
            f"{saves} (step, snapshot s, write s, bytes); fence "
            f"{arm['fence_count']} waits, {arm['fence_s']:.4f} s | {card}")
        del r
    out["cost_arms"] = arms
    log("resume phase: " + json.dumps(out))
    shutil.rmtree(workdir, ignore_errors=True)
    return out


# Phase 5e: fault injection and the localhost fleet on the ResNet-50 path.
# Every drill trains CHAOS_STEPS steps in chunks of STEPS_PER_LOOP, a
# checkpoint every STEPS_PER_LOOP: (a) NaN written into the batch of
# CHAOS_NAN_AT (the second row of the chunk 5-8); (b) a run of
# CHAOS_TORN_RUN steps whose final save is torn, resumed; (c) SIGTERM after
# CHAOS_SIGTERM_AT; (d) SIGKILL after CHAOS_KILL_AT, in a supervised child
# saving every CHAOS_KILL_EVERY steps: the save at the kill's step first
# waits for the one before it to be written, so the relaunch finds that
# one durable whatever the kill cuts short.
CHAOS_STEPS = 8
CHAOS_NAN_AT = 6
CHAOS_TORN_RUN = 6
CHAOS_SIGTERM_AT = 4
CHAOS_KILL_AT = 6
CHAOS_KILL_EVERY = 2
# The supervised drill's processes (launcher, child, relaunch), at most.
CHAOS_FLEET_TIMEOUT_S = 600


def _fit_over(wrap, cfg, workdir, label: str):
    """``_fit_once`` with ``build_dataset`` wrapped by ``wrap``."""
    from distributed_tensorflow_models_tpu_torch.harness import train as trainlib

    build = trainlib.build_dataset
    trainlib.build_dataset = lambda c, split="train", mesh=None: wrap(
        build(c, split, mesh))
    try:
        return _fit_once(cfg, workdir, label)
    finally:
        trainlib.build_dataset = build


def _checkpoint_diff(step_dir: Path, state) -> list:
    """Names of the state tensors in ``step_dir``'s ``state.pt`` that
    differ from ``state``'s (any name, shape, dtype or bit)."""
    import torch

    from distributed_tensorflow_models_tpu_torch.harness import checkpoint

    saved = torch.load(step_dir / "state.pt", weights_only=True)
    want, _ = checkpoint.flatten_state(state)
    if sorted(saved) != sorted(want):
        return ["<names>"]
    return [k for k in want if not torch.equal(saved[k], want[k].cpu())]


def _cli_in_process(argv: list) -> tuple:
    from distributed_tensorflow_models_tpu_torch.harness import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    return rc, json.loads(buf.getvalue().strip().splitlines()[-1])


def _supervised(argv: list, timeout_s: float) -> tuple:
    """``argv`` (the port's launcher) in a session of its own, its output
    captured; the whole session is killed if it outlives ``timeout_s``."""
    import signal

    proc = subprocess.Popen(argv, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        fail(f"chaos (d): the supervised fleet ran past {timeout_s} s; "
             f"stderr tail: {err[-2000:]}")
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    return proc.returncode, out, err


def phase_chaos(batch: int, card: str, workdir: Path, k1,
                k1_per_step: int) -> dict:
    """Fault injection (``resilience/chaos.py``) and the localhost fleet
    (``launch.py``) on the ResNet-50 path at full width (batch ``batch``,
    K1 on every 3x3 conv, chunks of ``STEPS_PER_LOOP``, a checkpoint every
    ``STEPS_PER_LOOP`` steps), every ``fit`` capturing the step once, in a
    workdir emptied first, against a straight run of ``CHAOS_STEPS``:

    (a) ``nan_policy="rollback"`` with ``--chaos nan_at_step=6``: the NaN
        is written into the stacked chunk 5-8 (its second row) before the
        step copies it in; one rollback to step 4, the chunk's batches
        skipped (the reference's rule: exactly the offending chunk), every
        state tensor and loss equal bit for bit to a straight run over the
        stream without batches 5-8, ``chaos/armed_unfired`` 0, the fire on
        the flight record;
    (b) ``torn_checkpoint_at_step=6`` on a 6-step run (its final save
        torn once durable): fsck reports the walk-back, and the rerun to 8
        restores step 4 and ends at the straight state;
    (c) the CLI with ``--chaos sigterm_at_step=4``: it exits 75
        (``RESUMABLE_EXIT_CODE``) after its emergency checkpoint at 4, and
        the same command again resumes at 4 to a step-8 checkpoint equal to
        the straight state;
    (d) the CLI under the port's launcher (``python -m ...launch
        --num-processes 1 --max-restarts 1``, so a world-1 NCCL group)
        with ``--chaos kill_at_step=6``: the child SIGKILLs itself once
        (the durable marker under ``.chaos_fired``), the launcher
        attributes the death to process 0, prints the startup milestones
        and relaunches it; the relaunch resumes from its checkpoint, exits
        0 with K1 at 50 a step it trained, and its step-8 checkpoint equals
        the straight state; ``metrics.jsonl`` rows carry the
        ``fleet/*`` gauges.  It saves every ``CHAOS_KILL_EVERY`` steps, so
        the save at step 6 waits for step 4's write and the relaunch
        resumes at 4.

    K1's counter must advance by ``k1_per_step`` for every step each
    in-process run executes (the rolled-back chunk included); each
    drill's seconds and the relaunch's milestones are printed.  Nothing
    here is caught: any mismatch fails the run."""
    import ast
    import socket

    import torch

    from distributed_tensorflow_models_tpu_torch import telemetry
    from distributed_tensorflow_models_tpu_torch.harness import train as trainlib
    from distributed_tensorflow_models_tpu_torch.harness.config import get_config
    from distributed_tensorflow_models_tpu_torch.resilience import fsck

    shutil.rmtree(workdir, ignore_errors=True)
    t_phase = time.perf_counter()
    cfg = get_config("resnet50_synthetic", global_batch_size=batch,
                     train_steps=CHAOS_STEPS, log_every_steps=STEPS_PER_LOOP,
                     checkpoint_every_secs=None,
                     checkpoint_every_steps=STEPS_PER_LOOP,
                     keep_checkpoints=2)
    seconds = {}
    k1_start = k1.launches

    def drill(label: str, steps: int, run):
        before = k1.launches
        t0 = time.perf_counter()
        out = run()
        seconds[label] = round(time.perf_counter() - t0, 3)
        got = k1.launches - before
        if got != k1_per_step * steps:
            fail(f"chaos {label}: K1 launched {got} times, expected "
                 f"{k1_per_step} x {steps} steps")
        return out

    straight = drill("straight", CHAOS_STEPS, lambda: _fit_once(
        cfg, None, "chaos straight"))
    want_losses = [h["loss"] for h in straight.history]
    # (a): the poisoned chunk runs, then its replay: 4 + 4 + 4 steps.
    rolled = drill("(a) nan_at_step", CHAOS_STEPS + STEPS_PER_LOOP,
                   lambda: _fit_once(cfg.replace(
                       nan_policy="rollback",
                       chaos={"nan_at_step": CHAOS_NAN_AT}),
                       workdir / "a", "chaos (a)"))
    snap = rolled.registry.snapshot()
    record = json.loads((workdir / "a" / "flight_recorder_p0.json")
                        .read_text())
    events = {e["name"] for e in record["events"]}
    if ((rolled.rollbacks, rolled.skipped_batches) != (1, STEPS_PER_LOOP)
            or [h["step"] for h in rolled.history]
            != list(range(1, CHAOS_STEPS + 1))
            or snap[telemetry.CHAOS_ARMED_UNFIRED] != 0.0
            or not {"chaos/nan_at_step", "train/rollback"} <= events):
        fail(f"chaos (a): {rolled.rollbacks} rollbacks, "
             f"{rolled.skipped_batches} skipped, steps "
             f"{[h['step'] for h in rolled.history]}, armed_unfired "
             f"{snap[telemetry.CHAOS_ARMED_UNFIRED]}, events {sorted(events)}")
    probe = trainlib.build_dataset(cfg)
    it = iter(probe)
    after = []
    for _ in range(CHAOS_STEPS):
        next(it)
        after.append(probe.get_state())
    del probe, it
    without = drill("(a) straight without 5-8", CHAOS_STEPS,
                    lambda: _fit_over(lambda ds: DropBatches(
                        ds, after[STEPS_PER_LOOP:2 * STEPS_PER_LOOP]), cfg,
                        None, "chaos (a) without"))
    diff = _state_diff(rolled.state, without.state)
    losses = [h["loss"] for h in rolled.history]
    if diff or losses != [h["loss"] for h in without.history]:
        fail(f"chaos (a): the rolled-back run differs from a straight run "
             f"without batches 5-8: {len(diff)} state tensors ({diff[:3]})")
    log(f"chaos (a): NaN written into row 2 of the chunk 5-8 (step "
        f"{CHAOS_NAN_AT}): 1 rollback to step {STEPS_PER_LOOP}, its "
        f"{STEPS_PER_LOOP} batches skipped, 1 capture, armed_unfired 0; "
        f"state and losses equal bit for bit to a straight run without "
        f"batches 5-8 | {card}")
    del rolled, without
    # (b)
    torn = {"torn_checkpoint_at_step": CHAOS_TORN_RUN}
    drill("(b) torn run", CHAOS_TORN_RUN, lambda: _fit_once(
        cfg.replace(train_steps=CHAOS_TORN_RUN, chaos=torn), workdir / "b",
        "chaos (b) torn run"))
    report = fsck.fsck_checkpoints(str(workdir / "b" / "checkpoints"))
    if (report["latest_step"], report["newest_valid_step"]) != (
            CHAOS_TORN_RUN, STEPS_PER_LOOP):
        fail(f"chaos (b): fsck says latest {report['latest_step']}, newest "
             f"valid {report['newest_valid_step']}")
    walked = drill("(b) resumed", CHAOS_STEPS - STEPS_PER_LOOP,
                   lambda: _fit_once(cfg.replace(chaos=torn), workdir / "b",
                                     "chaos (b) resumed"))
    diff = _state_diff(walked.state, straight.state)
    if walked.restored_from != STEPS_PER_LOOP or diff:
        fail(f"chaos (b): restored from {walked.restored_from}, {len(diff)} "
             f"state tensors differ from the straight run")
    log(f"chaos (b): step {CHAOS_TORN_RUN} torn (COMMITTED and "
        f"manifest.json deleted once durable), fsck: walk back to "
        f"{STEPS_PER_LOOP}; the resume restored {walked.restored_from} and "
        f"ended bit-identical | {card}")
    del walked
    # (c)
    flags = ["--config", "resnet50_synthetic", "--batch-size", str(batch),
             "--train-steps", str(CHAOS_STEPS), "--steps-per-loop",
             str(STEPS_PER_LOOP), "--log-every-steps", str(STEPS_PER_LOOP),
             "--device", "cuda"]
    argv = ["train", "--workdir", str(workdir / "c"), *flags,
            "--checkpoint-every-steps", str(STEPS_PER_LOOP), "--chaos",
            f"sigterm_at_step={CHAOS_SIGTERM_AT}"]
    torch.cuda.empty_cache()
    rc, out = drill("(c) sigterm", CHAOS_SIGTERM_AT,
                    lambda: _cli_in_process(argv))
    if (rc, out["preempted"], out["steps"], out["captures"]) != (
            75, True, CHAOS_SIGTERM_AT, 1):
        fail(f"chaos (c): the CLI returned {rc}: {out}")
    rc, out = drill("(c) rerun", CHAOS_STEPS - CHAOS_SIGTERM_AT,
                    lambda: _cli_in_process(argv))
    diff = _checkpoint_diff(workdir / "c" / "checkpoints" / str(CHAOS_STEPS),
                            straight.state)
    if (rc, out["restored_from"], out["steps"], out["captures"]) != (
            0, CHAOS_SIGTERM_AT, CHAOS_STEPS, 1) or diff:
        fail(f"chaos (c): the rerun returned {rc}: {out}; {len(diff)} state "
             f"tensors differ ({diff[:3]})")
    log(f"chaos (c): CLI --chaos sigterm_at_step={CHAOS_SIGTERM_AT} exited "
        f"75 (preempted at {CHAOS_SIGTERM_AT}); the same command resumed "
        f"and its step-{CHAOS_STEPS} checkpoint equals the straight run bit "
        f"for bit | {card}")
    k1_in_process = k1.launches - k1_start
    # (d)
    torch.cuda.empty_cache()
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    wd = workdir / "d"
    argv = [sys.executable, "-m", "distributed_tensorflow_models_tpu_torch."
            "launch", "--num-processes", "1", "--max-restarts", "1",
            "--term-grace", "10", "--coordinator", f"127.0.0.1:{port}", "--",
            sys.executable, "-m",
            "distributed_tensorflow_models_tpu_torch.harness.cli", "train",
            "--workdir", str(wd), *flags, "--checkpoint-every-steps",
            str(CHAOS_KILL_EVERY), "--chaos", f"kill_at_step={CHAOS_KILL_AT}"]
    t0 = time.perf_counter()
    rc, out, err = _supervised(argv, CHAOS_FLEET_TIMEOUT_S)
    seconds["(d) supervised"] = round(time.perf_counter() - t0, 3)
    lines = [line for line in out.splitlines()
             if line.startswith('{"final_metrics"')]
    mttr = {}
    for m in re.finditer(r"fleet startup MTTR \((launch|relaunch) (\d)\).*?"
                         r"p0=(\{[^}]*\})", err):
        mttr[f"{m.group(1)} {m.group(2)}"] = ast.literal_eval(m.group(3))
    if rc != 0 or len(lines) != 1:
        fail(f"chaos (d): the launcher exited {rc} with {len(lines)} result "
             f"lines; stderr tail: {err[-3000:]}")
    res = json.loads(lines[0])
    resumed_at = res["restored_from"]
    k1_relaunch = res["kernel_launches"].get("conv_implicit_gemm.launches", 0)
    rows = [json.loads(line) for line in
            (wd / "metrics.jsonl").read_text().splitlines()]
    report = json.loads((wd / "telemetry.json").read_text())
    diff = _checkpoint_diff(wd / "checkpoints" / str(CHAOS_STEPS),
                            straight.state)
    fleet_ok = rows and all(
        r.get(telemetry.FLEET_PEERS_ALIVE) == 1.0
        and r.get(telemetry.FLEET_STEP_LAG) == 0.0
        and telemetry.FLEET_HEARTBEAT_AGE in r for r in rows)
    if ("process 0 died on SIGKILL" not in err
            or "relaunch 1" not in mttr
            or not (wd / ".chaos_fired" / "kill_at_step").exists()
            or res["steps"] != CHAOS_STEPS or res["captures"] != 1
            or resumed_at != CHAOS_KILL_AT - CHAOS_KILL_EVERY
            or k1_relaunch != k1_per_step * (CHAOS_STEPS - resumed_at)
            or report["metrics"][telemetry.CHAOS_ARMED_UNFIRED] != 0.0
            or not fleet_ok or diff):
        fail(f"chaos (d): result {res}; milestones {mttr}; K1 in the "
             f"relaunch {k1_relaunch}; fleet rows {rows}; {len(diff)} state "
             f"tensors differ ({diff[:3]}); stderr tail: {err[-3000:]}")
    log(f"chaos (d): launcher (1 process, max 1 restart): the child "
        f"SIGKILLed itself after step {CHAOS_KILL_AT} (marker written), "
        f"'process 0 died on SIGKILL', relaunched; the relaunch resumed at "
        f"{resumed_at}, K1 {k1_relaunch} launches ({k1_per_step} x "
        f"{CHAOS_STEPS - resumed_at} steps), its step-{CHAOS_STEPS} "
        f"checkpoint equals the straight run bit for bit; metrics.jsonl "
        f"fleet/* gauges at steps {[r['step'] for r in rows]} | {card}")
    for key in sorted(mttr):
        log(f"chaos (d) startup milestones, {key}: {mttr[key]} (seconds "
            f"from spawn: first beat, loop entry, first step) | {card}")
    seconds["phase"] = round(time.perf_counter() - t_phase, 3)
    log(f"chaos phase seconds: {seconds} | {card}")
    shutil.rmtree(workdir, ignore_errors=True)
    return {"k1_launches": k1_in_process, "k1_relaunch": k1_relaunch,
            "seconds": seconds, "milestones": mttr}


# Phase 5d: a run's telemetry and its evaluation.  ResNet-50 at full width
# through fit with a workdir: TELEMETRY_STEPS steps, the hooks every
# TELEMETRY_EVERY; eval of its checkpoint over EVAL_BATCHES batches;
# transformer_lm trained LM_TRAIN_STEPS steps and evaluated over
# LM_EVAL_BATCHES.
TELEMETRY_STEPS = 12
TELEMETRY_EVERY = 4
EVAL_BATCHES = 8
LM_TRAIN_STEPS = 4
LM_EVAL_BATCHES = 4
# FLOPs of one resnet50_synthetic training step per image of the batch, as
# train_loop.step_flops counts them (every tap of each padded conv,
# forward and backward; elementwise work 0): the count taken on the CPU
# (meta device) for batch 256, 6,220,563,873,792, over 256.
R50_STEP_FLOPS_PER_IMAGE = 24_299_077_632
# K1 against its plain version in eval: each conv's bf16 output may round
# the other way, so near-tied logits of the random-weight model can swap
# ranks; at most 1 % of the examples may change their top-1 or top-5
# verdict, and the mean xent may move by 2^-7 relative.  K2 against its
# plain version: the perplexity to 1e-3 relative.
EVAL_COUNT_TOL = 0.01
EVAL_XENT_RTOL = 2.0 ** -7
LM_PPL_RTOL = 1e-3
# Keys TelemetryHook injects into every metrics.jsonl row at its cadence.
TELEMETRY_KEYS = ("step_time_s", "data_wait_s", "dispatch_s",
                  "steps_per_sec", "stall_fraction", "mfu", "compile_count",
                  "compile_s", "checkpoint_s", "startup/restore_s",
                  "startup/time_to_first_step_s", "host_queue_depth",
                  "restarts", "rollbacks", "skipped_batches")
# Declared registry keys a one-process run does not emit: no fault
# injection, fleet or serving stack in the port, no restore in a fresh
# run, one input worker (no pool), no watchdog.
ALLOW_MISSING = ("chaos/", "fleet/", "serve/", "checkpoint/restore",
                 "pipeline/reassembly_wait", "pipeline/worker_busy",
                 "train/watchdog_last_progress_s")


@contextlib.contextmanager
def plain_kernels():
    """Every K1/K6 launch and every K2 launch replaced by its plain
    version on the same CUDA tensors (``conv_mxu._core_reference`` on the
    materialised window, ``attention._flash_forward_reference``); the
    launch counters do not move."""
    from distributed_tensorflow_models_tpu_torch.ops import attention
    from distributed_tensorflow_models_tpu_torch.ops import conv_mxu

    def k1_plain(x, kernel, win, pipelined, out=None):
        kh, kw = kernel.shape[:2]
        h0, w0, sh, sw, oh, ow = win
        y = conv_mxu._core_reference(conv_mxu._materialize_window(
            x, (h0, w0, sh, sw, oh + kh - 1, ow + kw - 1)), kernel)
        return y if out is None else out.copy_(y)

    saved = conv_mxu._launch_window, attention.flash_forward
    conv_mxu._launch_window = k1_plain
    attention.flash_forward = attention._flash_forward_reference
    try:
        yield
    finally:
        conv_mxu._launch_window, attention.flash_forward = saved


@contextlib.contextmanager
def without_telemetry_hooks():
    """``fit`` with an inert hook in place of ``TelemetryHook`` and
    ``TensorBoardHook``: the arm that prices them."""
    from distributed_tensorflow_models_tpu_torch.harness import hooks
    from distributed_tensorflow_models_tpu_torch.harness import train

    class Inert(hooks.Hook):
        def __init__(self, *args, **kw):
            pass

        def wants_step(self, step):
            return False

    saved = train.hooklib.TelemetryHook, train.hooklib.TensorBoardHook
    train.hooklib.TelemetryHook = train.hooklib.TensorBoardHook = Inert
    try:
        yield
    finally:
        train.hooklib.TelemetryHook, train.hooklib.TensorBoardHook = saved


def fit_kept(cfg, workdir: Path):
    """``fit`` on the card in chunks of ``STEPS_PER_LOOP`` into ``workdir``,
    its checkpoint kept for an eval; fails unless the step was captured
    once and replayed for every later step."""
    import torch

    from distributed_tensorflow_models_tpu_torch.harness import train as trainlib

    cfg = cfg.replace(steps_per_loop=STEPS_PER_LOOP)
    torch.cuda.empty_cache()
    r = trainlib.fit(cfg, str(workdir), device="cuda")
    if (r.captures, r.replayed_steps) != (1, cfg.train_steps - 1):
        fail(f"{cfg.name}: {r.captures} captures, {r.replayed_steps} "
             f"replayed steps of {cfg.train_steps}")
    summarize_run({"steps": r.state.step}, r.history, cfg.train_steps)
    return r


def check_telemetry(workdir: Path, steps: int, every: int) -> dict:
    """The run's ``telemetry.json``, ``metrics.jsonl`` and TensorBoard
    events: the four fractions sum to 1, a capture counted as a compile
    event, the step's FLOPs counted, a row every ``every`` steps carrying
    the telemetry keys, one event record per row behind the file's
    version record (each record's checksums verified); both files pass
    the repository's schema lint.  Returns the report and the rows."""
    import torch

    from distributed_tensorflow_models_tpu_torch.data import tfrecord

    report = json.loads((workdir / "telemetry.json").read_text())
    frac = report["fractions"]
    if (set(frac) != {"compute", "data_stall", "checkpoint", "compile"}
            or abs(math.fsum(frac.values()) - 1.0) > 1e-9
            or min(frac.values()) < 0):
        fail(f"telemetry.json fractions {frac}")
    if report["compile_events"] < 1 or not report["flops_per_step"] > 0:
        fail(f"telemetry.json: {report['compile_events']} compile events, "
             f"flops_per_step {report['flops_per_step']}")
    if (report["steps"], report["device_kind"], report["n_devices"]) != (
            steps, torch.cuda.get_device_name(0), 1):
        fail(f"telemetry.json: steps {report['steps']}, device "
             f"{report['device_kind']}, {report['n_devices']} devices")
    rows = [json.loads(line) for line in
            (workdir / "metrics.jsonl").read_text().splitlines()]
    if [r["step"] for r in rows] != list(range(every, steps + 1, every)):
        fail(f"metrics.jsonl rows at steps {[r['step'] for r in rows]}")
    for row in rows:
        missing = [k for k in TELEMETRY_KEYS if k not in row]
        if missing or not all(math.isfinite(row[k]) for k in TELEMETRY_KEYS):
            fail(f"metrics.jsonl row {row['step']}: missing {missing}")
    (events,) = (workdir / "tensorboard").iterdir()
    records = list(tfrecord.read_records(events))
    if len(records) != 1 + len(rows) or b"brain.Event:2" not in records[0]:
        fail(f"{events}: {len(records)} records for {len(rows)} rows")
    lint = str(ROOT / "scripts" / "check_metrics_schema.py")
    allow = [a for p in ALLOW_MISSING for a in ("--allow-missing", p)]
    registry = str(ROOT / "distributed_tensorflow_models_tpu_torch"
                   / "telemetry" / "registry.py")
    for args in ([str(workdir / "metrics.jsonl"), "--require-telemetry"],
                 [str(workdir / "telemetry.json"), "--declared-coverage",
                  registry, *allow]):
        proc = subprocess.run([sys.executable, lint, *args],
                              capture_output=True, text=True)
        if proc.returncode:
            fail(f"schema lint {args[1:]}: {proc.stderr}{proc.stdout}")
    return {"report": report, "rows": rows}


def phase_telemetry_eval(batch: int, card: str, workdir: Path,
                         fwd_per_batch: int, seed: int) -> dict:
    """Phase 5d: a run's telemetry and its evaluation on the card."""
    import torch

    from distributed_tensorflow_models_tpu_torch.harness import evaluate
    from distributed_tensorflow_models_tpu_torch.harness.config import get_config
    from distributed_tensorflow_models_tpu_torch.ops import attention
    from distributed_tensorflow_models_tpu_torch.ops import conv as convlib
    from distributed_tensorflow_models_tpu_torch.ops import conv_mxu

    k1, k6 = conv_mxu.conv_implicit_gemm, conv_mxu.conv_implicit_gemm_pipelined
    k2 = attention.flash_forward
    cfg = get_config("resnet50_synthetic", global_batch_size=batch,
                     train_steps=TELEMETRY_STEPS,
                     log_every_steps=TELEMETRY_EVERY,
                     checkpoint_every_secs=10_000.0, seed=seed)
    # (a) The K1 arm and the F.conv2d arm: the same FLOPs, the CPU's.
    arms, tele = {}, {}
    for label, impl, hooks in (("K1", "mxu", True),
                               ("F.conv2d", "xla", True),
                               ("K1 without the hooks", "mxu", False)):
        convlib.set_default_conv_impl(impl)
        zero_counts((k1, k6))
        arm_dir = workdir / f"telemetry{len(arms)}"
        with (contextlib.nullcontext() if hooks
              else without_telemetry_hooks()):
            arms[label] = fit_kept(cfg, arm_dir)
        want = fwd_per_batch * 2 * TELEMETRY_STEPS if impl == "mxu" else 0
        if (k1.launches, k6.launches) != (want, 0):
            fail(f"telemetry arm {label}: K1 {k1.launches}, K6 "
                 f"{k6.launches} launches, expected {want} and 0")
        if hooks:
            tele[label] = check_telemetry(arm_dir, TELEMETRY_STEPS,
                                          TELEMETRY_EVERY)
        if label != "K1":
            shutil.rmtree(arm_dir / "checkpoints", ignore_errors=True)
    convlib.set_default_conv_impl("mxu")
    want_flops = R50_STEP_FLOPS_PER_IMAGE * batch
    counts = {label: t["report"]["flops_per_step"]
              for label, t in tele.items()}
    log(f"FLOPs a ResNet-50 step (batch {batch}) by arm: {counts}; counted "
        f"on the CPU: {want_flops}")
    if set(counts.values()) != {want_flops}:
        fail(f"flops_per_step {counts}, expected {want_flops} on every arm")
    for label, t in tele.items():
        rep, r = t["report"], arms[label]
        steady = (rep["flops_per_step"] * r.window_steps
                  / (r.window_s * rep["peak_bf16_flops"])
                  if rep["peak_bf16_flops"] else 0.0)
        log(f"telemetry.json, ResNet-50 {label}: MFU {rep['mfu']:.6f} over "
            f"the run's {rep['total_s']:.3f} s (peak "
            f"{rep['peak_bf16_flops']} FLOP/s for {rep['device_kind']}), "
            f"{steady:.6f} over the timed window ({r.window_steps} steps, "
            f"{r.window_s * 1e3:.1f} ms); fractions {rep['fractions']}; "
            f"seconds {rep['seconds']}; {rep['compile_events']} compile "
            f"events; startup {rep['startup']}; interval MFU by row "
            f"{[(row['step'], round(row['mfu'], 6)) for row in t['rows']]}"
            f" | {card}")
    for label, r in arms.items():
        log(f"hooks' cost, ResNet-50 arm {label}: {r.images_per_sec:.1f} "
            f"images/s over {r.window_steps} replayed steps "
            f"({r.window_s * 1e3:.1f} ms) | {card}")

    # (b) Eval of the K1 arm's checkpoint: K1, its plain version and
    # F.conv2d on the same batches.
    ckpt = workdir / "telemetry0"
    evals = {}
    for label, impl, plain in (("K1", "mxu", False), ("F.conv2d", "xla", False),
                               ("K1's plain version", "mxu", True)):
        convlib.set_default_conv_impl(impl)
        zero_counts((k1, k6))
        with plain_kernels() if plain else contextlib.nullcontext():
            ev = evaluate.evaluate_classification(
                cfg, str(ckpt), device="cuda", max_batches=EVAL_BATCHES)
        want = fwd_per_batch * EVAL_BATCHES if impl == "mxu" and not plain else 0
        if (k1.launches, k6.launches) != (want, 0):
            fail(f"eval {label}: K1 {k1.launches}, K6 {k6.launches} "
                 f"launches, expected {want} and 0")
        if ev.step != TELEMETRY_STEPS or ev.metrics["count"] != (
                batch * EVAL_BATCHES):
            fail(f"eval {label}: step {ev.step}, {ev.metrics}")
        evals[label] = ev
        log(f"eval ResNet-50 {label}: {ev.metrics}; K1 launches "
            f"{k1.launches} ({k1.launches / EVAL_BATCHES:g} a batch); "
            f"{ev.metrics['count'] / ev.seconds:.1f} images/s over "
            f"{ev.seconds:.3f} s | {card}")
    convlib.set_default_conv_impl("mxu")
    got, ref = evals["K1"].metrics, evals["K1's plain version"].metrics
    n = ref["count"]
    flips = {k: abs(got[k] - ref[k]) * n for k in ("top1", "top5")}
    xent_rel = abs(got["xent"] - ref["xent"]) / abs(ref["xent"])
    log(f"eval K1 against its plain version: top-1/top-5 examples changed "
        f"{flips} of {n:g} (tolerance {EVAL_COUNT_TOL * n:g}), xent "
        f"relative difference {xent_rel:.3e} (tolerance {EVAL_XENT_RTOL:.3e})")
    if max(flips.values()) > EVAL_COUNT_TOL * n or xent_rel > EVAL_XENT_RTOL:
        fail("eval on K1 disagrees with its plain version")
    shutil.rmtree(ckpt / "checkpoints", ignore_errors=True)

    # (c) transformer_lm: trained with flash, evaluated on K2 and on its
    # plain version.
    lm_cfg = get_config("transformer_lm", attn_impl="flash",
                        train_steps=LM_TRAIN_STEPS,
                        checkpoint_every_secs=10_000.0, seed=seed)
    layers = lm_cfg.model_kwargs["num_layers"]
    lm_dir = workdir / "telemetry_lm"
    fit_kept(lm_cfg, lm_dir)
    lm = {}
    for label, plain in (("K2", False), ("K2's plain version", True)):
        k2.launches = 0
        with plain_kernels() if plain else contextlib.nullcontext():
            ev = evaluate.evaluate_lm(lm_cfg, str(lm_dir), device="cuda",
                                      max_batches=LM_EVAL_BATCHES)
        want = 0 if plain else layers * LM_EVAL_BATCHES
        if k2.launches != want:
            fail(f"LM eval {label}: K2 launched {k2.launches}, expected "
                 f"{want}")
        if not math.isfinite(ev.metrics["perplexity"]):
            fail(f"LM eval {label}: {ev.metrics}")
        tokens = lm_cfg.global_batch_size * lm_cfg.num_steps * LM_EVAL_BATCHES
        lm[label] = (ev, want)
        log(f"eval transformer_lm {label}: {ev.metrics}; K2 launches "
            f"{k2.launches} ({k2.launches // LM_EVAL_BATCHES} a batch); "
            f"{tokens / ev.seconds:.1f} tokens/s over {ev.seconds:.3f} s | "
            f"{card}")
    ppl = [lm[label][0].metrics["perplexity"] for label in lm]
    ppl_rel = abs(ppl[0] - ppl[1]) / ppl[1]
    log(f"LM eval K2 against its plain version: perplexity relative "
        f"difference {ppl_rel:.3e} (tolerance {LM_PPL_RTOL:.0e})")
    if ppl_rel > LM_PPL_RTOL:
        fail("LM eval on K2 disagrees with its plain version")
    shutil.rmtree(lm_dir / "checkpoints", ignore_errors=True)
    return {"k1_eval_launches": fwd_per_batch * EVAL_BATCHES,
            "k2_eval_launches": layers * LM_EVAL_BATCHES}


def _flash_inputs(shape, seed: int):
    import numpy as np
    import torch

    _, B, Tq, Tkv, H, Hkv, D, causal, window, qo, ko, with_glse, _ = shape
    rng = np.random.default_rng(seed)

    def bf16(*dims):
        return torch.from_numpy(rng.standard_normal(
            dims, dtype=np.float32)).cuda().bfloat16()

    q, do = bf16(B, Tq, H, D), bf16(B, Tq, H, D)
    k, v = bf16(B, Tkv, Hkv, D), bf16(B, Tkv, Hkv, D)
    g_lse = bf16(B, Tq, H).float() if with_glse else None
    kw = dict(scale=D ** -0.5, causal=causal, window=window, q_offset=qo,
              kv_offset=ko)
    return q, k, v, do, g_lse, kw


def _flash_work(shape):
    """Valid (query, key) pairs per (batch, head) row, from the mask."""
    import torch

    from distributed_tensorflow_models_tpu_torch.ops import attention as attnlib

    _, B, Tq, Tkv, H, Hkv, D, causal, window, qo, ko, _, _ = shape
    valid = attnlib._valid(Tq, Tkv, causal, window, qo, ko, "cuda")
    pairs = Tq * Tkv if valid is None else int(valid.sum())
    rows = (torch.ones(Tq, dtype=torch.bool, device="cuda") if valid is None
            else valid.any(-1))
    return pairs, rows


def flash_bound_ms(kid: str, shape, pairs: int) -> tuple[float, str]:
    """Least time for one launch: the bytes it must move (each input read
    once, each output written once) over the memory rate, or its
    tensor-core FLOPs on the valid pairs over the bf16 peak.  K2 reads Q,
    K, V and writes O and the f32 LSE, 4*D FLOPs a pair; K3 reads Q, K, V,
    dO, LSE and delta and writes per-query-head dK and dV, 8*D; K4 reads
    the same and writes dQ, 6*D.  K5's dKV launch is K3 plus the bf16 dS
    of every valid pair written; its dQ launch reads those dS and K and
    writes dQ, 2*D a pair."""
    _, B, Tq, Tkv, H, Hkv, D, *_ = shape
    q_b, kv_b = 2.0 * B * Tq * H * D, 2.0 * B * Tkv * Hkv * D
    rows_b = 4.0 * B * H * Tq
    ds_b = 2.0 * B * H * pairs
    if kid == "K2":
        nbytes, per_pair = 2 * q_b + 2 * kv_b + rows_b, 4
    elif kid in ("K3", "K5 dKV"):
        nbytes = 2 * q_b + 2 * kv_b + 2 * rows_b + 2 * (2.0 * B * Tkv * H * D)
        per_pair = 8
        if kid == "K5 dKV":
            nbytes += ds_b
    elif kid == "K5 dQ":
        nbytes, per_pair = ds_b + kv_b + q_b, 2
    else:
        nbytes, per_pair = 3 * q_b + 2 * kv_b + 2 * rows_b, 6
    flops = float(per_pair) * D * pairs * B * H
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def _flash_err(what: str, got, want) -> float:
    got, want = got.float(), want.float()
    scale = float(want.abs().max())
    err = (got - want).abs()
    bad = err > FLASH_ATOL_OF_SCALE * scale + FLASH_RTOL * want.abs()
    max_abs = float(err.max())
    if bool(bad.any()) or not math.isfinite(max_abs):
        fail(f"{what} disagrees with its plain version: {int(bad.sum())} of "
             f"{bad.numel()} elements over atol {FLASH_ATOL_OF_SCALE * scale:.3g}"
             f" + rtol {FLASH_RTOL:.3g}; max abs err {max_abs:.4g}")
    return max_abs


@contextlib.contextmanager
def flash_lib(lib):
    """The flash wrappers launch ``lib``'s kernels inside the block (none:
    this tree's own)."""
    from distributed_tensorflow_models_tpu_torch.ops import attention as attnlib

    if lib is None:
        yield
        return
    own = attnlib._load()
    attnlib._lib = lib
    try:
        yield
    finally:
        attnlib._lib = own


def _staged(args, kw):
    """K5's two launches with the current flash library, the dKV launch
    writing into a stage filled with NaN first: ``(dk, dv, stage, dq)``."""
    import torch

    from distributed_tensorflow_models_tpu_torch.ops import attention as attnlib

    q, k = args[:2]
    stage = torch.full((q.shape[0] * q.shape[2], q.shape[1], k.shape[1]),
                       float("nan"), dtype=torch.bfloat16, device="cuda")
    sdk, sdv, stage = attnlib.flash_dkv_staged(*args, **kw, ds=stage)
    sdq = attnlib.flash_dq_staged(stage, k, **kw)
    torch.cuda.synchronize()
    return sdk, sdv, stage, sdq


def phase_flash(seed: int, parent=None) -> dict:
    """K2 to K5 against their plain versions at FLASH_SHAPES; at the timed
    shapes also their times (CUDA events over back-to-back launches, and
    the kernel alone by CUDA-graph replay), bounds and the SDPA yardstick
    (its forward, and its backward by graph replay of a fresh forward and
    backward less the forward's own graph time).  K5's dKV launch writes
    into a dS stage filled with NaN first, so a tile its dQ launch reads
    but the dKV launch never wrote shows as NaN in dQ; its dK and dV must
    equal K3's bit for bit, and its dQ K4's (element by element, the count
    that differ printed).  With ``parent`` (another tree's flash library)
    the same count is taken, and only printed, with that tree's K4 and K5,
    and its K2-K5 are replayed in turns with this tree's (parent, this,
    this, parent).  Returns, per kernel id, the worst error and the
    timings by shape, and K5's dQ differences from K4 by shape (this
    tree's, and the parent's)."""
    import torch
    import torch.nn.functional as F

    from distributed_tensorflow_models_tpu_torch.ops import attention as attnlib

    out = {kid: {"max_abs_err": 0.0, "timed": {}}
           for kid, _, _ in FLASH_KERNELS + STAGED_KERNELS}
    out["dq_vs_k4"] = {}
    out["dq_vs_k4_parent"] = {}
    for n, shape in enumerate(FLASH_SHAPES):
        name, B, Tq, Tkv, H, Hkv, D, causal, window, qo, ko, _, timed = shape
        q, k, v, do, g_lse, kw = _flash_inputs(shape, seed + n)
        pairs, rows = _flash_work(shape)
        o, lse = attnlib.flash_forward(q, k, v, **kw)
        torch.cuda.synchronize()
        ref_o, ref_lse = attnlib._flash_forward_reference(q, k, v, **kw)
        errs = {"K2": _flash_err(f"K2 out at {name}", o[:, rows],
                                 ref_o[:, rows])}
        lse_err = float((lse - ref_lse)[:, :, rows].abs().max())
        if not lse_err <= LSE_ATOL:
            fail(f"K2 lse at {name}: max abs err {lse_err:.4g} > {LSE_ATOL}")
        if not bool(rows.all()):
            fail(f"{name}: every query row needs a valid key here")
        delta = (do.float() * o.float()).sum(-1)
        if g_lse is not None:
            delta = delta - g_lse
        delta = delta.transpose(1, 2).contiguous()
        args = (q, k, v, do, lse, delta)
        dk, dv = attnlib.flash_dkv(*args, **kw)
        dq = attnlib.flash_dq(*args, **kw)
        torch.cuda.synchronize()
        ref_dk, ref_dv = attnlib._flash_dkv_reference(*args, **kw)
        ref_dq = attnlib._flash_dq_reference(*args, **kw)
        errs["K3"] = max(_flash_err(f"K3 dk at {name}", dk, ref_dk),
                         _flash_err(f"K3 dv at {name}", dv, ref_dv))
        errs["K4"] = _flash_err(f"K4 dq at {name}", dq, ref_dq)
        del ref_o, ref_lse, ref_dk, ref_dv, ref_dq
        sdk, sdv, stage, sdq = _staged(args, kw)
        if not (torch.equal(sdk, dk) and torch.equal(sdv, dv)):
            fail(f"K5 dK/dV at {name} differ from K3's")
        if bool(torch.isnan(sdq).any()):
            fail(f"K5 dq at {name} holds NaN: its dQ launch read a dS tile "
                 f"the dKV launch did not write")
        ref_sdk, ref_sdv, ref_ds = attnlib._flash_dkv_staged_reference(
            *args, **kw)
        ref_sdq = attnlib._flash_dq_staged_reference(ref_ds, k, **kw)
        errs["K5 dKV"] = max(_flash_err(f"K5 dk at {name}", sdk, ref_sdk),
                             _flash_err(f"K5 dv at {name}", sdv, ref_sdv))
        errs["K5 dQ"] = _flash_err(f"K5 dq at {name}", sdq, ref_sdq)
        n_diff = int((sdq != dq).sum())
        max_diff = float((sdq.float() - dq.float()).abs().max())
        out["dq_vs_k4"][name] = dict(differing=n_diff, of=sdq.numel(),
                                     max_abs_diff=max_diff)
        del ref_sdk, ref_sdv, ref_sdq, sdk, sdv
        log(f"K5 at {name}: dK and dV equal K3's bit for bit; dq differs "
            f"from K4's in {n_diff} of {sdq.numel()} elements, max abs diff "
            f"{max_diff:.4g}; no NaN from the NaN-filled stage")
        if n_diff:
            fail(f"K5 dq at {name} differs from K4's: the pair and staged "
                 f"backwards must give the same dQ")
        if parent is not None:
            with flash_lib(parent):
                psdq = _staged(args, kw)[3]
                pdq = attnlib.flash_dq(*args, **kw)
            p_diff = int((psdq != pdq).sum())
            out["dq_vs_k4_parent"][name] = dict(
                differing=p_diff, of=psdq.numel(),
                max_abs_diff=float((psdq.float() - pdq.float()).abs().max()))
            log(f"  parent tree at {name}: its K5 dq differs from its K4's in "
                f"{p_diff} of {psdq.numel()} elements (this tree: {n_diff})")
            del psdq, pdq
        log(f"flash {name}: B{B} Tq{Tq} Tkv{Tkv} H{H} Hkv{Hkv} D{D} causal "
            f"{causal} window {window} offsets {qo}/{ko} lse cotangent "
            f"{g_lse is not None}; max abs err K2 {errs['K2']:.4g} (lse "
            f"{lse_err:.3g}), K3 {errs['K3']:.4g}, K4 {errs['K4']:.4g}, K5 "
            f"dKV {errs['K5 dKV']:.4g}, K5 dQ {errs['K5 dQ']:.4g}; valid "
            f"pairs per (batch, head) {pairs}")
        for kid, err in errs.items():
            out[kid]["max_abs_err"] = max(out[kid]["max_abs_err"], err)
        if not timed:
            continue
        fns = {
            "K2": (lambda: attnlib.flash_forward(q, k, v, **kw),
                   lambda: attnlib._flash_forward_reference(q, k, v, **kw)),
            "K3": (lambda: attnlib.flash_dkv(*args, **kw),
                   lambda: attnlib._flash_dkv_reference(*args, **kw)),
            "K4": (lambda: attnlib.flash_dq(*args, **kw),
                   lambda: attnlib._flash_dq_reference(*args, **kw)),
            "K5 dKV": (lambda: attnlib.flash_dkv_staged(*args, **kw,
                                                        ds=stage),
                       lambda: attnlib._flash_dkv_staged_reference(*args,
                                                                   **kw)),
            "K5 dQ": (lambda: attnlib.flash_dq_staged(stage, k, **kw),
                      lambda: attnlib._flash_dq_staged_reference(ref_ds, k,
                                                                 **kw)),
        }
        # SDPA (the yardstick) on the same values, heads-second views; with
        # GQA or a window, enable_gqa and the explicit mask.
        qs, ks, vs = (t.transpose(1, 2).detach().requires_grad_()
                      for t in (q, k, v))
        if window is None and Hkv == H and qo == ko:
            sdpa_kw = dict(is_causal=causal)
        else:
            sdpa_kw = dict(attn_mask=attnlib._valid(Tq, Tkv, causal, window,
                                                    qo, ko, "cuda"),
                           enable_gqa=Hkv != H)

        def sdpa():
            return F.scaled_dot_product_attention(qs, ks, vs, **sdpa_kw)

        so = sdpa()
        gs = do.transpose(1, 2)
        lib = {"K2": time_ms(sdpa, 20),
               "K3+K4": time_ms(lambda: torch.autograd.grad(
                   so, (qs, ks, vs), gs, retain_graph=True), 20)}
        # Device times by graph replay: SDPA's forward, and its backward as
        # a fresh forward and backward captured together, less that fresh
        # forward.  The fresh forward runs on copies of the inputs made in
        # the graph (leaves whose autograd nodes live on the capture
        # stream; the copies cost the same in both graphs).
        lib_dev = {"K2": graph_ms(sdpa)}

        def fresh_forward():
            ins = [t.detach().clone().requires_grad_() for t in (qs, ks, vs)]
            return ins, F.scaled_dot_product_attention(*ins, **sdpa_kw)

        def fresh_backward():
            ins, so_fresh = fresh_forward()
            torch.autograd.grad(so_fresh, ins, gs)

        lib_dev["K3+K4"] = graph_ms(fresh_backward) - graph_ms(fresh_forward)
        log(f"  SDPA at {name} by graph replay: forward {lib_dev['K2']:.4f} "
            f"ms, backward (dQ, dK and dV) {lib_dev['K3+K4']:.4f} ms "
            f"(events from Python: {lib['K2']:.4f}, {lib['K3+K4']:.4f})")
        encode_us = 1e6 * attnlib.flash_forward_encode_seconds(q, k, v)
        log(f"  K2 at {name}: its three TMA tensor maps take {encode_us:.2f} "
            f"us of host time to encode, each launch")
        for kid, (kern, plain) in fns.items():
            ms = time_ms(kern, 20)
            plain_ms = time_ms(plain, 3, 1)
            bms, bound_by = flash_bound_ms(kid, shape, pairs)
            lk = "K2" if kid == "K2" else "K3+K4"
            # This tree's kernel alone, and the parent's in turns with it.
            if parent is None:
                dev_ms = graph_ms(kern)
                parent_ms = None
            else:
                runs = []
                for which in (parent, None, None, parent):
                    with flash_lib(which):
                        runs.append(graph_ms(kern))
                dev_ms = (runs[1] + runs[2]) / 2
                parent_ms = (runs[0] + runs[3]) / 2
            rec = dict(ms=ms, plain_ms=plain_ms, bound_ms=bms,
                       bound_by=bound_by, device_ms=dev_ms,
                       library_ms=lib[lk] if kid == "K2" else lib_dev[lk],
                       library_device_ms=lib_dev[lk],
                       library_events_ms=lib[lk])
            if parent_ms is not None:
                rec["parent_device_ms"] = parent_ms
                rec["parent_device_runs_ms"] = [runs[0], runs[3]]
                rec["device_runs_ms"] = [runs[1], runs[2]]
            if kid == "K2":
                rec["map_encode_us"] = encode_us
            out[kid]["timed"][name] = rec
            log(f"  {kid} at {name}: {ms:.4f} ms per launch (events), "
                f"{dev_ms:.4f} ms alone (graph replay, {bms / dev_ms:.1%} of "
                f"the bound)"
                + ("" if parent_ms is None else
                   f", the parent tree's {parent_ms:.4f} ms in turns "
                   f"({runs[0]:.4f} {runs[1]:.4f} {runs[2]:.4f} "
                   f"{runs[3]:.4f})")
                + f"; plain {plain_ms:.4f} ms; bound {bms:.4f} ms "
                f"({bound_by}); SDPA "
                + ("forward" if kid == "K2" else "backward (dQ, dK and dV)")
                + f" {lib_dev[lk]:.4f} ms alone, {lib[lk]:.4f} ms events")
        del qs, ks, vs, so, sdpa_kw, q, k, v, do, o, lse, dk, dv, dq, args
        del fns
        del stage, ref_ds, sdq
        torch.cuda.empty_cache()
    return out


def run_lm_arm(config: str, impl: str, steps: int, workdir: Path) -> dict:
    from distributed_tensorflow_models_tpu_torch.harness.config import get_config

    batch = get_config(config).global_batch_size
    return run_named(config, steps, batch, workdir, attn_impl=impl)


def log_arm(label: str, r: dict, per_step: int, card: str) -> None:
    """One arm's end-to-end rate over its timed window (closed by a device
    sync), its step time and wait for input there, its capture and its
    peak memory; ``per_step`` is the images (or tokens, for an LM) of one
    step."""
    unit = "tokens" if r.get("tokens_per_sec") else "images"
    rate = r["tokens_per_sec"] if unit == "tokens" else r["images_per_sec"]
    log(f"arm {label:>18}: {rate:.1f} {unit}/s end to end over "
        f"{r['window_steps']} replayed steps ({r['window_s'] * 1e3:.1f} ms "
        f"between device syncs, the wait for input included); step "
        f"{r['steady_step_time_s'] * 1e3:.3f} ms less the wait "
        f"({per_step / r['steady_step_time_s']:.1f} {unit}/s for the step "
        f"alone); wait for input (data_s) median "
        f"{r['median_data_s'] * 1e3:.3f} ms, mean {r['data_s'] * 1e3:.3f} ms "
        f"a step; {r['captures']} capture in {r['capture_s']:.2f} s, "
        f"{r['replayed_steps']} steps replayed; peak memory "
        f"{r['peak_gib']:.2f} GiB allocated, {r['peak_reserved_gib']:.2f} "
        f"GiB reserved | {card}")


def zero_counts(fns) -> None:
    for fn in fns:
        fn.launches = 0
        for attr in ("f32_launches", "wgmma_launches", "simt_launches"):
            if hasattr(fn, attr):
                setattr(fn, attr, 0)


# Phase 12's configs: the CLI's named configs, and VGG-16 and AlexNet on
# resnet50_synthetic with the JAX bench's settings (bench.py
# build_vgg16/build_alexnet: 224x224, batch 64 and 128, L2 5e-4, TF
# momentum at 0.1 x batch / 256 decayed 0.9 every 2000 steps).  The bench
# feeds stacked device batches; here four input workers keep the host
# pipeline ahead of these short steps (one worker assembles a 128-image
# batch in ~30 ms, more than AlexNet's step).
def bench_overrides(model: str, batch: int) -> dict:
    """``resnet50_synthetic``'s fields for VGG-16 or AlexNet with the JAX
    bench's settings, the optimizer as a dict of its fields (so a process
    of another tree can take them as JSON)."""
    return {"model": model, "global_batch_size": batch, "weight_decay": 5e-4,
            "data_workers": 4,
            "optimizer": {"name": "momentum",
                          "learning_rate": 0.1 * batch / 256,
                          "decay_steps": 2000, "decay_rate": 0.9}}


def named_config(config: str, over: dict):
    """``get_config(config, **over)``, an ``optimizer`` dict of ``over``
    made an ``OptimizerConfig``."""
    from distributed_tensorflow_models_tpu_torch.harness.config import (
        OptimizerConfig,
        get_config,
    )

    over = dict(over)
    if "optimizer" in over:
        over["optimizer"] = OptimizerConfig(**over["optimizer"])
    return get_config(config, **over)


def bench_config(model: str, batch: int, steps: int):
    return named_config("resnet50_synthetic", {
        **bench_overrides(model, batch), "train_steps": steps,
    }).replace(name=f"{model}_synthetic")


def phase_zoo_path(label: str, runner, per_step: int, k1_per_step: int,
                   f32: bool, arms, card: str, workdir: Path) -> dict:
    """One new conv path through ``fit``: each arm ``(impl, knob, name)``
    with K1's and K6's counters zeroed just before it and read just after.
    A K1 arm (mxu, knob 0) must launch K1 ``k1_per_step`` times a step
    (all in f32 for an f32 model) and K6 never; a K6 arm the reverse; an
    ``F.conv2d`` arm neither.  Returns the first K1 arm's and the K6 arm's
    counts and every arm's summary."""
    from distributed_tensorflow_models_tpu_torch.ops import conv as convlib
    from distributed_tensorflow_models_tpu_torch.ops import conv_mxu

    k1, k6 = conv_mxu.conv_implicit_gemm, conv_mxu.conv_implicit_gemm_pipelined
    out = {"arms": [], "k1": None, "k6": None}
    for impl, knob, name in arms:
        convlib.set_default_conv_impl(impl)
        os.environ["DTM_CONV_MXU_PIPELINE"] = knob
        zero_counts((k1, k6))
        r = runner(workdir / f"{label}{len(out['arms'])}")
        steps = r["steps"]
        got = {"K1": (k1.launches, k1.f32_launches),
               "K6": (k6.launches, k6.f32_launches)}
        on = None if impl != "mxu" else ("K6" if knob == "1" else "K1")
        want = {kid: ((k1_per_step * steps, k1_per_step * steps if f32 else 0)
                      if kid == on else (0, 0)) for kid in got}
        log(f"{label} arm {name}: launches (all, f32) {got}, expected "
            f"{want} ({k1_per_step} a step x {steps} steps); peak memory "
            f"{r['peak_gib']:.2f} GiB; losses {r['losses']}")
        if got != want:
            fail(f"{label} {name} arm launched {got}, expected {want}")
        if on is not None and out[on.lower()] is None:
            out[on.lower()] = got[on]
        out["arms"].append((name, r))
    convlib.set_default_conv_impl("mxu")
    os.environ["DTM_CONV_MXU_PIPELINE"] = "0"
    for name, r in out["arms"]:
        log_arm(f"{label} {name}", r, per_step, card)
    return out


def phase_ptb(steps: int, card: str, workdir: Path) -> dict:
    """``ptb_medium`` at full width through ``fit``: tokens/s, the wait for
    input, step times, peak memory and the losses, which must be finite
    and fall (the later half's mean under the first step's).  Then two
    steps of ``fit`` in this process: the carry reaching step 2 is the
    model's, per layer ``[20, 650]`` f32 on the card with no graph.  Then
    a profile of the step."""
    import torch

    from distributed_tensorflow_models_tpu_torch.harness import train as trainlib
    from distributed_tensorflow_models_tpu_torch.harness.config import get_config

    cfg = get_config("ptb_medium")
    r = run_named("ptb_medium", steps, cfg.global_batch_size, workdir / "ptb")
    losses = r["losses"]
    late = losses[len(losses) // 2:]
    log(f"ptb_medium (hidden 650, 2 layers, vocab 10000, dropout 0.5, batch "
        f"{cfg.global_batch_size} x {cfg.num_steps} steps of unroll): losses "
        f"{losses}; peak memory {r['peak_gib']:.3f} GiB | {card}")
    if not sum(late) / len(late) < losses[0]:
        fail(f"ptb_medium's losses do not fall: {losses}")
    log_arm("ptb_medium", r, cfg.global_batch_size * cfg.num_steps, card)
    two = trainlib.fit(cfg.replace(train_steps=2), device="cuda")
    hidden = two.state.model.hidden_size
    if hidden != 650 or len(two.state.carry) != 2:
        fail(f"ptb_medium built hidden {hidden}, "
             f"{len(two.state.carry)} layers")
    for layer, pair in enumerate(two.state.carry):
        for what, t in zip(("c", "h"), pair):
            if (tuple(t.shape) != (cfg.global_batch_size, hidden)
                    or t.dtype != torch.float32 or not t.is_cuda
                    or t.grad_fn is not None or t.requires_grad):
                fail(f"ptb_medium carry {what}{layer} at step 2: "
                     f"{tuple(t.shape)} {t.dtype} {t.device} grad_fn "
                     f"{t.grad_fn}")
    log(f"ptb_medium carry at step 2: {len(two.state.carry)} layers of (c, "
        f"h), each [{cfg.global_batch_size}, {hidden}] float32 on the card, "
        f"detached (no grad_fn)")
    phase_profile(cfg, "ptb_medium")
    return r


def phases_zoo(steps: int, seed: int, card: str, workdir: Path) -> dict:
    """Phases 11-13: K1 and K6 at every launch shape of the new conv paths
    (ResNet-32 in f32 at batch 128, VGG-16 at batch 64 and AlexNet at 128
    in bf16, 224x224), those paths and LeNet through ``fit`` in turns with
    ``F.conv2d``, with profiles of their K1 arms, and ``ptb_medium``."""
    from distributed_tensorflow_models_tpu_torch.harness.config import get_config

    # 11. K1 and K6 at every launch shape of the new paths.
    shapes, res = {}, {}
    for label, model, size, batch, kw, f32 in (
            ("ResNet-32", "resnet32_cifar", 32, 128, {}, True),
            ("VGG-16", "vgg16", 224, 64, {"dropout_rate": 0.0}, False),
            ("AlexNet", "alexnet", 224, 128, {"dropout_rate": 0.0}, False)):
        calls = core_launch_shapes(model, size, batch, **kw)
        roles = collections.Counter(r for r, _, _ in calls)
        log(f"conv core launches per {label} step at batch {batch} "
            f"({'f32' if f32 else 'bf16'}): {len(calls)} ({dict(roles)}), "
            f"{len({(x, w) for _, x, w in calls})} distinct shapes")
        if not calls or roles["fwd"] != roles["dx"]:
            fail(f"{label}: expected a dx launch for every forward one, got "
                 f"{dict(roles)}")
        shapes[label] = len(calls)
        # ResNet-32's 8x8 maps make a launch from Python slower than the
        # kernel: its shapes are timed by graph replay.
        res[label] = phase_k1(calls, seed, f32=f32, replay=f32)
    if shapes["ResNet-32"] != 18:
        fail(f"ResNet-32 should launch the core 18 times a step (9 "
             f"forward, 9 dx), got {shapes['ResNet-32']}")
    # LeNet's convs (Cin 1 and 32) route to patches: no launch to check.
    shapes["LeNet"] = len(core_launch_shapes("lenet", 28, 64, channels=1,
                                             dropout_rate=0.0))
    log(f"conv core launches per LeNet step: {shapes['LeNet']}")

    # 12. The new conv paths through fit: a K1 arm and an F.conv2d arm
    # (and, for ResNet-32, a K6 arm); a profile of each K1 arm.
    k1_arms = (("mxu", "0", "K1"), ("xla", "0", "F.conv2d"))
    r32 = get_config("resnet32_cifar10")
    lenet = get_config("lenet_mnist")
    vgg = bench_config("vgg16", 64, steps)
    alex = bench_config("alexnet", 128, steps)
    paths = {}
    for label, cfg, runner, k1_step, f32, arms in (
            ("ResNet-32", r32, lambda wd: run_named(
                "resnet32_cifar10", steps, r32.global_batch_size, wd),
             shapes["ResNet-32"], True,
             k1_arms + (("mxu", "1", "K6"),)),
            ("LeNet", lenet, lambda wd: run_named(
                "lenet_mnist", steps, lenet.global_batch_size, wd),
             shapes["LeNet"], True, k1_arms),
            ("VGG-16", vgg, lambda wd: run_fit(vgg, wd), shapes["VGG-16"],
             False, k1_arms),
            ("AlexNet", alex, lambda wd: run_fit(alex, wd),
             shapes["AlexNet"], False, k1_arms)):
        paths[label] = phase_zoo_path(
            label, runner, cfg.global_batch_size, k1_step, f32, arms, card,
            workdir)
        phase_profile(cfg, f"{label}, K1 convs" if k1_step
                      else f"{label}, mxu route (patches: no K1 conv)")

    # 13. The PTB LSTM at full width.
    ptb = phase_ptb(steps, card, workdir)
    return {"k1": res, "paths": paths, "ptb": ptb, "shapes": shapes}


# The decode phase (14): the LM checkpoint's training, the CLI's generate,
# and the decode path at full width.  GEN_* are its sizes: transformer_lm's
# batch and segment as the prompt, and as many new tokens, which fills the
# 512-slot cache; beam search at batch 4 with 4 beams; ptb_medium's batch
# and unroll as its prompt.
GEN_TRAIN_STEPS = 4
GEN_NEW_TOKENS = 256
GEN_CLI_NEW_TOKENS = 32
BEAM_BATCH, BEAM_SIZE = 4, 4
RNN_NEW_TOKENS = 64
# Decode logits (bf16 model; reference attention over the cache) against
# the full forward on K2 at the same positions: both round P to bf16 at
# the same points and differ by K2's running-max rescale and summation
# order (its 2^-6 relative plus 1e-2 of scale on the attention output,
# phase 8), carried through 4 layers and the f32 head: 2^-5 of the
# logits' largest magnitude.
DECODE_ATOL_OF_SCALE = 2.0 ** -5
# The startup phase's children (15): transformer_lm on flash resumed from
# the decode phase's checkpoint for STARTUP_STEPS more steps, each in a
# fresh process; (aot_compile, xla_cache_dir) per arm, in turns.
STARTUP_STEPS = 4
STARTUP_ARMS = (("on", True, None), ("off", False, None),
                ("off, fresh build", False, ""), ("on, fresh build", True, ""))
STARTUP_CHILD = r'''
import json, os, sys, time
t0 = time.perf_counter()
import torch
t_torch = time.perf_counter() - t0
sys.path.insert(0, sys.argv[1])
t1 = time.perf_counter()
from distributed_tensorflow_models_tpu_torch import launch
from distributed_tensorflow_models_tpu_torch.harness import config, train
t_port = time.perf_counter() - t1
t2 = time.perf_counter()
if not launch.initialize_from_env(device="cuda"):
    raise SystemExit("no cluster in the environment")
torch.empty(1, device="cuda")
torch.cuda.synchronize()
t_init = time.perf_counter() - t2
spec = json.loads(sys.argv[3])
cfg = config.get_config("transformer_lm", attn_impl="flash",
                        train_steps=spec["steps"], steps_per_loop=4,
                        checkpoint_every_secs=1e9,
                        aot_compile=spec["aot"],
                        xla_cache_dir=spec["cache"])
t3 = time.perf_counter()
r = train.fit(cfg, sys.argv[2], device="cuda")
t_fit = time.perf_counter() - t3
ev = {}
for e in r.registry.trace.events():
    if "dur_s" in e and e["name"] not in ev:
        ev[e["name"]] = e["dur_s"]
snap = r.registry.snapshot()
print(json.dumps({
    "import_torch_s": t_torch, "import_port_s": t_port,
    "cuda_nccl_init_s": t_init,
    "fit_to_first_step_s": snap["startup/time_to_first_step_s"],
    "process_to_first_step_s": (t3 - t0
                                + snap["startup/time_to_first_step_s"]),
    "fit_s": t_fit, "restored_from": r.restored_from,
    "captures": r.captures, "spans": ev,
    "aot_compile_s": snap["startup/aot_compile_s"],
    "compile_total_s": snap.get("train/compile/total_s", 0.0),
    "losses": [h["loss"] for h in r.history]}))
torch.distributed.destroy_process_group()
'''


def train_lm_checkpoint(workdir: Path, flash_fns: dict, steps: int):
    """``transformer_lm`` (flash: K2-K4) trained ``steps`` steps through
    ``fit`` with ``workdir``, which keeps its final checkpoint; the flash
    counters zeroed just before and read just after (4 layers x steps of
    K2, K3 and K4 each, no K5)."""
    from distributed_tensorflow_models_tpu_torch.harness import train as trainlib
    from distributed_tensorflow_models_tpu_torch.harness.config import get_config

    cfg = get_config("transformer_lm", attn_impl="flash", train_steps=steps,
                     steps_per_loop=STEPS_PER_LOOP,
                     checkpoint_every_secs=1e9)
    layers = cfg.model_kwargs["num_layers"]
    zero_counts(flash_fns.values())
    r = trainlib.fit(cfg, str(workdir), device="cuda")
    got = {kid: fn.launches for kid, fn in flash_fns.items()}
    want = {kid: layers * steps if kid in ("K2", "K3", "K4") else 0
            for kid in flash_fns}
    if got != want or r.state.step != steps or r.captures != 1:
        fail(f"decode phase: the checkpoint's training launched {got} "
             f"(expected {want}), reached step {r.state.step} with "
             f"{r.captures} captures")
    log(f"decode phase: transformer_lm trained {steps} steps on flash "
        f"(launches {got}), losses {[h['loss'] for h in r.history]}; its "
        f"checkpoint is in {workdir}")
    return cfg, got


def _restored_lm(cfg, workdir: Path):
    import torch

    from distributed_tensorflow_models_tpu_torch.harness import (
        checkpoint as ckptlib,
    )
    from distributed_tensorflow_models_tpu_torch.harness import train as trainlib

    state, _ = ckptlib.CheckpointManager(str(workdir)).restore(
        trainlib.build_state(cfg, torch.device("cuda")))
    return state


def _timed(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def decode_at_width(label: str, model, prompt, card: str, k2) -> dict:
    """One LM's decode at full width: greedy ``generate`` captured (one
    capture, a replay per later token) against every step eager (tokens
    and each step's logits bit for bit), the decode logits against the
    full forward on K2 (its counter zeroed just before, read just after:
    one launch a layer), a sampled stream captured against eager and
    repeated from its seed, and the two timed in turns.  R1 at this
    path's shapes: every launch of one prompt pass and of one step held
    to its plain version and timed (``_r1_table``), and its counters,
    zeroed just before the timed captured ``generate`` and read just
    after, each form's at one prompt pass's launches of that form plus
    one step's per later token (the eager first step and each
    replay)."""
    import torch

    from distributed_tensorflow_models_tpu_torch.harness import generate as genlib
    from distributed_tensorflow_models_tpu_torch.ops import rowwise

    n = GEN_NEW_TOKENS
    B, T = prompt.shape
    cache = model.init_cache(B, "cuda")
    prompt_calls, lg = _record_r1(lambda: model(prompt, cache=cache)[0])
    step_calls, _ = _record_r1(lambda: model(
        lg[:, -1].argmax(-1, keepdim=True), cache=cache)[0])
    del cache, lg
    r1_prompt = _r1_table(prompt_calls, f"{label} decode: R1, the "
                          f"[{B}, {T}] prompt pass", card)
    r1_step = _r1_table(step_calls, f"{label} decode: R1, one [{B}, 1] "
                        f"step", card)
    del prompt_calls, step_calls
    caps, reps = genlib.captures, genlib.replays
    zero_counts([rowwise.row_matmul])
    (got, got_lg), cap_s = _timed(lambda: genlib.generate(
        model, prompt, n, capture=True, return_logits=True))
    r1_launches = rowwise.row_matmul.launches
    r1_forms = {form: getattr(rowwise.row_matmul, f"{form}_launches")
                for form in ("wgmma", "simt")}
    if (genlib.captures - caps, genlib.replays - reps) != (1, n - 2):
        fail(f"{label}: generate captured {genlib.captures - caps} times "
             f"and replayed {genlib.replays - reps} (expected 1 and {n - 2})")
    r1_want = r1_prompt["launches"] + (n - 1) * r1_step["launches"]
    forms_want = {form: r1_prompt["forms"][form]
                  + (n - 1) * r1_step["forms"][form] for form in r1_forms}
    if r1_launches != r1_want or r1_forms != forms_want:
        fail(f"{label}: the captured generate launched R1 {r1_launches} "
             f"times ({r1_forms} by form), expected {r1_prompt['launches']} "
             f"for the prompt pass + {n - 1} x {r1_step['launches']} = "
             f"{r1_want} ({forms_want})")
    (want, want_lg), eager_s = _timed(lambda: genlib.generate(
        model, prompt, n, capture=False, return_logits=True))
    if not (torch.equal(got, want) and torch.equal(got_lg, want_lg)):
        fail(f"{label}: the replayed decode step differs from the eager one "
             f"({int((got != want).sum())} tokens differ)")
    zero_counts([k2])
    with torch.no_grad():
        full, _ = model(got[:, :T + n])
    if k2.launches != model.num_layers:
        fail(f"{label}: the full forward launched K2 {k2.launches} times, "
             f"expected {model.num_layers}")
    k2_launches = k2.launches
    ref = full[:, T - 1:T + n - 1].float()
    err = float((got_lg - ref).abs().max())
    scale = float(ref.abs().max())
    agree = float((ref.argmax(-1) == got[:, T:]).float().mean())
    if not err <= DECODE_ATOL_OF_SCALE * scale:
        fail(f"{label}: decode logits differ from the K2 full forward by "
             f"{err} (scale {scale}, bound {DECODE_ATOL_OF_SCALE} x scale)")
    sample = dict(temperature=0.8, top_k=40, top_p=0.95, seed=1)
    s_cap = genlib.generate(model, prompt, n, capture=True, **sample)
    s_eager = genlib.generate(model, prompt, n, capture=False, **sample)
    s_again = genlib.generate(model, prompt, n, capture=True, **sample)
    if not (torch.equal(s_cap, s_eager) and torch.equal(s_cap, s_again)):
        fail(f"{label}: the sampled stream differs between capture, eager "
             f"and a repeat from its seed")
    walls = {"captured": [cap_s], "eager": [eager_s]}
    for arm in ("captured", "eager"):
        _, s = _timed(lambda: genlib.generate(model, prompt, n,
                                              capture=arm == "captured"))
        walls[arm].append(s)
    cache = model.init_cache(B, "cuda")
    cache_bytes = sum(t.numel() * t.element_size()
                      for t in (*cache.keys, *cache.values))
    del cache
    best = {arm: min(v) for arm, v in walls.items()}
    log(f"{label} decode: batch {B}, prompt {T}, {n} new tokens (the "
        f"{T + n}-slot cache full: {cache_bytes} bytes of bf16 KV); "
        f"captured = eager bit for bit (tokens and every step's logits), "
        f"greedy and sampled; logits vs the K2 full forward max abs "
        f"{err:.5f} of scale {scale:.3f} (bound {DECODE_ATOL_OF_SCALE} x "
        f"scale), greedy tokens = its argmax at {agree:.4f} of positions; "
        f"K2 {k2_launches} launches in that forward | {card}")
    log(f"{label} decode walls (prompt pass + {n - 1} steps, synced), "
        f"in turns: captured {[round(s, 4) for s in walls['captured']]} s, "
        f"eager {[round(s, 4) for s in walls['eager']]} s; best: "
        f"{B * n / best['captured']:.1f} tokens/s captured "
        f"({best['captured'] / n * 1e3:.3f} ms a token), "
        f"{B * n / best['eager']:.1f} tokens/s eager "
        f"({best['eager'] / n * 1e3:.3f} ms a token); R1 {r1_launches} "
        f"launches in the timed captured run ({r1_forms['wgmma']} "
        f"tensor-core, {r1_forms['simt']} SIMT) | {card}")
    return {"err": err, "scale": scale, "agree": agree,
            "k2_launches": k2_launches, "cache_bytes": cache_bytes,
            "r1_launches": r1_launches, "r1_forms": r1_forms,
            "r1_prompt": r1_prompt,
            "r1_step": r1_step,
            "tokens_per_s_captured": B * n / best["captured"],
            "tokens_per_s_eager": B * n / best["eager"],
            "ms_per_token_captured": best["captured"] / n * 1e3,
            "ms_per_token_eager": best["eager"] / n * 1e3}


def phase_generate(card: str, workdir: Path, flash_fns: dict) -> dict:
    """Phase 14, the decode path (``harness/generate.py``, the model's
    ``KVCache``, the CLI's ``generate``) at full width."""
    import numpy as np
    import torch

    from distributed_tensorflow_models_tpu_torch.harness import generate as genlib
    from distributed_tensorflow_models_tpu_torch.harness import train as trainlib
    from distributed_tensorflow_models_tpu_torch.harness.config import get_config

    t_phase = time.perf_counter()
    ckpt = workdir / "lm"
    cfg, train_launches = train_lm_checkpoint(ckpt, flash_fns,
                                              GEN_TRAIN_STEPS)
    # (b) The CLI's generate in a process of its own on that checkpoint,
    # and the same greedy continuation in this process.
    tokens = [int(t) for t in np.random.RandomState(0).randint(0, 10000, 16)]
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m",
         "distributed_tensorflow_models_tpu_torch.harness.cli", "generate",
         "--config", "transformer_lm", "--workdir", str(ckpt), "--prompt",
         ",".join(map(str, tokens)), "--max-new-tokens",
         str(GEN_CLI_NEW_TOKENS)], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    cli_s = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"cli generate exited {proc.returncode}: {proc.stderr[-2000:]}")
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    state = _restored_lm(cfg, ckpt)
    model = state.model
    mine = genlib.generate(model, torch.tensor([tokens], device="cuda"),
                           GEN_CLI_NEW_TOKENS)[0].tolist()
    if (line["step"], line["prompt"], line["tokens"]) != (
            GEN_TRAIN_STEPS, tokens, mine):
        fail(f"cli generate printed {line}, expected step "
             f"{GEN_TRAIN_STEPS} and the tokens {mine}")
    log(f"decode phase: CLI generate --config transformer_lm --prompt (16 "
        f"tokens) --max-new-tokens {GEN_CLI_NEW_TOKENS}: exit 0 in "
        f"{cli_s:.2f} s (a fresh process), step {line['step']}, its greedy "
        f"tokens = this process's generate on the restored model")
    # (c) transformer_lm (restored) and transformer_lm_modern (seeded init)
    # at their config widths: batch 16, a 256-token prompt from PTB.
    results = {}
    for name in ("transformer_lm", "transformer_lm_modern"):
        lm_cfg = get_config(name, attn_impl="flash")
        if name != "transformer_lm":
            model = trainlib.build_model(lm_cfg, torch.device("cuda"))
        model.eval()
        batch = next(iter(trainlib.build_dataset(lm_cfg)))
        prompt = torch.from_numpy(batch["inputs"]).cuda()
        results[name] = decode_at_width(name, model, prompt, card,
                                        flash_fns["K2"])
    # (d) Beam search on transformer_lm: batch 4, 4 beams, 256 new tokens.
    model = state.model
    prompt = torch.from_numpy(next(iter(trainlib.build_dataset(cfg)))[
        "inputs"][:BEAM_BATCH]).cuda()
    def beam(capture):
        return _timed(lambda: genlib.beam_search(
            model, prompt, GEN_NEW_TOKENS, beam_size=BEAM_SIZE,
            capture=capture))

    caps = genlib.captures
    (bt, bs), beam_s = beam(True)
    if genlib.captures - caps != 1:
        fail(f"beam search captured {genlib.captures - caps} times")
    (et, es), beam_eager_s = beam(False)
    if not (torch.equal(bt, et) and torch.equal(bs, es)):
        fail(f"beam search: {genlib.captures - caps} captures; captured = "
             f"eager: tokens {torch.equal(bt, et)}, scores "
             f"{torch.equal(bs, es)}")
    greedy = genlib.generate(model, prompt, GEN_NEW_TOKENS)
    log(f"decode phase: beam search, batch {BEAM_BATCH} x {BEAM_SIZE} beams,"
        f" {GEN_NEW_TOKENS} new tokens: captured = eager bit for bit (tokens"
        f" and scores); {beam_s:.3f} s captured, "
        f"{beam_eager_s:.3f} s eager;"
        f" scores {[round(float(s), 3) for s in bs]}, greedy's tokens equal "
        f"the best beam's in {int((greedy == bt).all(1).sum())} of "
        f"{BEAM_BATCH} rows | {card}")
    # (e) generate_rnn on ptb_medium (seeded init): batch 20, prompt 35.
    ptb = get_config("ptb_medium")
    rnn = trainlib.build_model(ptb, torch.device("cuda"))
    rnn.eval()
    prompt = torch.from_numpy(next(iter(trainlib.build_dataset(ptb)))[
        "inputs"]).cuda()
    def rnn_run(capture):
        return _timed(lambda: genlib.generate_rnn(
            rnn, prompt, RNN_NEW_TOKENS, capture=capture))

    caps = genlib.captures
    rt, rnn_s = rnn_run(True)
    if genlib.captures - caps != 1:
        fail(f"generate_rnn captured {genlib.captures - caps} times")
    re_, rnn_eager_s = rnn_run(False)
    if not torch.equal(rt, re_):
        fail("generate_rnn: captured differs from eager")
    for capture in (True, False):
        s = rnn_run(capture)[1]
        if capture:
            rnn_s = min(rnn_s, s)
        else:
            rnn_eager_s = min(rnn_eager_s, s)
    log(f"decode phase: generate_rnn on ptb_medium (hidden 650), batch "
        f"{prompt.shape[0]}, prompt {prompt.shape[1]}, {RNN_NEW_TOKENS} new:"
        f" captured = eager bit for bit; best of two in turns "
        f"{prompt.shape[0] * RNN_NEW_TOKENS / rnn_s:.1f} tokens/s captured "
        f"(the capture included), "
        f"{prompt.shape[0] * RNN_NEW_TOKENS / rnn_eager_s:.1f} eager | {card}")
    log(f"decode phase: {time.perf_counter() - t_phase:.1f} s")
    return {"ckpt": ckpt, "train_launches": train_launches,
            "k2_decode_check": sum(r["k2_launches"]
                                   for r in results.values()),
            "r1_launches": sum(r["r1_launches"] for r in results.values()),
            "r1_forms": {form: sum(r["r1_forms"][form]
                                   for r in results.values())
                         for form in ("wgmma", "simt")},
            "paths": results}


def phase_startup(card: str, workdir: Path, ckpt: Path) -> dict:
    """Phase 15, the cold start (``harness/startup.py``): ``transformer_lm``
    on flash resumed from ``ckpt`` for ``STARTUP_STEPS`` steps, each arm
    of ``STARTUP_ARMS`` in a fresh process in a world-1 NCCL group, with
    the startup thread on and off, on the kept build and on a fresh one
    (nvcc into a temporary directory): the split of the time before the
    first step, from the child's own clocks and its run's trace.  Every
    arm ends at the same losses, one capture each."""
    import socket

    from distributed_tensorflow_models_tpu_torch import launch

    t_phase = time.perf_counter()
    arms = []
    for label, aot, cache in STARTUP_ARMS:
        wd = workdir / f"startup{len(arms)}"
        shutil.copytree(ckpt, wd)
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        env = {**os.environ, launch.ENV_COORDINATOR: f"127.0.0.1:{port}",
               launch.ENV_NUM_PROCESSES: "1", launch.ENV_PROCESS_ID: "0"}
        spec = {"steps": GEN_TRAIN_STEPS + STARTUP_STEPS, "aot": aot,
                "cache": cache}
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c", STARTUP_CHILD, str(ROOT), str(wd),
             json.dumps(spec)], cwd=ROOT, env=env, capture_output=True,
            text=True, timeout=600)
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            fail(f"startup arm {label} exited {proc.returncode}: "
                 f"{proc.stderr[-3000:]}")
        r = json.loads(proc.stdout.strip().splitlines()[-1])
        if r["restored_from"] != GEN_TRAIN_STEPS or r["captures"] != 1:
            fail(f"startup arm {label}: {r}")
        r["label"], r["wall_s"] = label, wall
        arms.append(r)
        shutil.rmtree(wd, ignore_errors=True)
    if any(r["losses"] != arms[0]["losses"] for r in arms):
        fail(f"startup arms differ: {[r['losses'] for r in arms]}")
    keys = ("fit/build_state", "startup/kernel_load", "startup/flops_count",
            "train/flops_count", "startup/aot_compile", "fit/restore",
            "startup/aot_join", "train/data_wait", "train/eager_step",
            "train/capture")
    for r in arms:
        split = {k: round(r["spans"][k], 4) for k in keys if k in r["spans"]}
        log(f"startup arm {r['label']:>16}: import torch "
            f"{r['import_torch_s']:.3f} s, the port {r['import_port_s']:.3f} "
            f"s, CUDA + NCCL group init {r['cuda_nccl_init_s']:.3f} s; fit "
            f"entry to its first step {r['fit_to_first_step_s']:.3f} s "
            f"(process start to first step "
            f"{r['process_to_first_step_s']:.3f} s, child wall "
            f"{r['wall_s']:.2f} s); spans (s) {split}; startup/aot_compile_s"
            f" {r['aot_compile_s']:.3f}, train/compile {r['compile_total_s']:.3f}"
            f" s | {card}")
    log(f"startup phase: {len(arms)} arms, the same losses "
        f"{arms[0]['losses']}, one capture each; "
        f"{time.perf_counter() - t_phase:.1f} s")
    return {"arms": arms}


# Phase 16: the Switch-MoE transformer and the model knobs.  Training arms
# run KNOB_STEPS steps (a chunk, then a timed chunk of replays); Inception
# runs at KNOB_INCEPTION_BATCH to keep the phase's time.  The MoE FFN's
# card-against-CPU check: the share of equal expert choices at least
# MOE_CHOICE_SHARE; rows routed to the same slot within f32 summation
# order (MOE_RTOL plus MOE_ATOL_OF_SCALE of the output's scale); aux and
# the dropped fraction within MOE_SCALAR_TOL.  The embedding's two
# gradients: the same f32 sums in another order, each rounded once to
# the bf16 table (one ulp, 2^-7 relative) plus 1e-6 of the scale.  The
# q-chunked blockwise against the unchunked loop: the same f32 products
# per row, each bf16 output rounded once: one ulp plus 1e-3 of the scale.
KNOB_STEPS = 8
KNOB_INCEPTION_BATCH = 128
MOE_CHOICE_SHARE = 0.999
MOE_RTOL = 1e-4
MOE_ATOL_OF_SCALE = 1e-5
MOE_SCALAR_TOL = 1e-4
EMBED_RTOL = 2.0 ** -7
EMBED_ATOL_OF_SCALE = 1e-6
BLOCKQ = 64
BLOCKQ_SHAPE = (4, 2048, 8, 64)
BLOCKQ_RTOL = 2.0 ** -7
BLOCKQ_ATOL_OF_SCALE = 1e-3


def _eager_run(cfg, steps: int) -> tuple[list, list]:
    """``steps`` eager steps of ``cfg`` on the dataset's own stream from
    the config's seeded state: (losses, the final state's tensors)."""
    import itertools

    import torch

    from distributed_tensorflow_models_tpu_torch.harness import train as trainlib

    dev = torch.device("cuda")
    state = trainlib.build_state(cfg, dev)
    step = trainlib.build_step(cfg, state)
    losses = []
    for b in itertools.islice(iter(trainlib.build_dataset(cfg)), steps):
        state, metrics = step(state, {k: torch.from_numpy(v).to(dev)
                                      for k, v in b.items()}, cfg.seed)
        losses.append(float(metrics["loss"]))
    return losses, [t.clone() for t in state_tensors(state)]


def _lm_states_close(label: str, got, want, a, b, card: str) -> None:
    """Losses within 1e-5 relative and the states within 1e-4 in relative
    L2 (the LM step's embedding gradient sums rows with atomics)."""
    import torch

    loss_rel = max(abs(x - y) / abs(y) for x, y in zip(got, want))
    floats = [(x.float(), y.float()) for x, y in zip(a, b)
              if x.is_floating_point()]
    total = rel_l2(torch.cat([x.flatten() for x, _ in floats]),
                   torch.cat([y.flatten() for _, y in floats]))
    same = sum(bool(torch.equal(x, y)) for x, y in zip(a, b))
    log(f"{label}: losses {got} against {want}; largest loss difference "
        f"{loss_rel:.3g} relative; {same} of {len(a)} state tensors equal "
        f"bit for bit, state rel L2 {total:.3g} (bound 1e-4: atomics) "
        f"| {card}")
    if len(a) != len(b) or loss_rel > 1e-5 or total > 1e-4:
        fail(f"{label}: loss {loss_rel:.3g} relative, state {total:.3g} in "
             f"relative L2, over 1e-5 and 1e-4")


def _flops_of(r) -> float:
    from distributed_tensorflow_models_tpu_torch import telemetry

    return r.registry.snapshot().get(telemetry.FLOPS_PER_STEP, 0.0)


def _moe_check(cfg, seed: int, card: str) -> dict:
    """One ``moe_ffn`` at the config's token count on the card against the
    port's CPU ``moe_ffn`` on the same seeded f32 inputs."""
    import numpy as np
    import torch

    from distributed_tensorflow_models_tpu_torch.parallel import moe

    kw = cfg.model_kwargs
    n, d, f, e = (cfg.global_batch_size * cfg.num_steps, kw["d_model"],
                  kw["d_ff"], kw["num_experts"])
    params = moe.init_moe_params(e, d, f, torch.Generator().manual_seed(seed))
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (n, d), dtype=np.float32))
    cap = moe.capacity(1.25, n, e)
    res = {}
    for dev in ("cpu", "cuda"):
        p = {k: v.to(dev) for k, v in params.items()}
        xd = x.to(dev)
        t0 = time.perf_counter()
        out = moe.moe_ffn(p, xd, mesh=None)
        with moe._exact_f32_matmul():
            choice = torch.argmax(torch.softmax(xd @ p["router"], -1), -1)
        dispatch = moe._route_local(xd, p["router"], e, cap)[0]
        if dev == "cuda":
            torch.cuda.synchronize()
        res[dev] = (out, choice.cpu(), dispatch.cpu(),
                    time.perf_counter() - t0)
    (a, ca, da, _), (b, cb, db, cpu_s) = res["cuda"], res["cpu"]
    share = float((ca == cb).float().mean())
    rows = (da == db).flatten(1).all(1)
    scale = float(b.out.abs().max())
    err = (a.out.cpu()[rows] - b.out[rows]).abs()
    limit = MOE_RTOL * b.out[rows].abs() + MOE_ATOL_OF_SCALE * scale
    aux_d = abs(float(a.aux_loss) - float(b.aux_loss))
    drop_d = abs(float(a.dropped_fraction) - float(b.dropped_fraction))
    p_dev = {k: v.cuda() for k, v in params.items()}
    x_dev = x.cuda()
    ms = time_ms(lambda: moe.moe_ffn(p_dev, x_dev, mesh=None), 5)
    log(f"moe_ffn at {n} tokens, d {d}, f {f}, {e} experts, capacity {cap}: "
        f"card against CPU: {share:.6f} of the expert choices equal "
        f"(needed {MOE_CHOICE_SHARE}); {int(rows.sum())} of {n} rows in the "
        f"same slot, max abs err {float(err.max()):.3g} there (scale "
        f"{scale:.3g}); aux {float(a.aux_loss):.6f} (CPU "
        f"{float(b.aux_loss):.6f}), dropped fraction "
        f"{float(a.dropped_fraction):.6f} (CPU "
        f"{float(b.dropped_fraction):.6f}); forward {ms:.3f} ms on the card "
        f"(events), {cpu_s:.2f} s on the CPU | {card}")
    if (share < MOE_CHOICE_SHARE or not bool((err <= limit).all())
            or aux_d > MOE_SCALAR_TOL or drop_d > MOE_SCALAR_TOL):
        fail(f"moe_ffn card against CPU: choices {share:.6f}, err "
             f"{float(err.max()):.3g}, aux {aux_d:.3g}, dropped {drop_d:.3g}")
    return {"choice_share": share, "dropped_fraction":
            float(a.dropped_fraction), "aux": float(a.aux_loss), "ms": ms}


def _embed_check(card: str) -> dict:
    """``DTM_EMBED_GRAD=matmul`` against ``scatter`` on one
    ``transformer_lm`` step (flash, the same dropout bits): the embedding
    gradient; then both backward lowerings timed at its shape."""
    import torch

    from distributed_tensorflow_models_tpu_torch.harness.config import get_config
    from distributed_tensorflow_models_tpu_torch.harness import train as trainlib
    from distributed_tensorflow_models_tpu_torch.ops import embed

    dev = torch.device("cuda")
    cfg = get_config("transformer_lm", attn_impl="flash")
    state = trainlib.build_state(cfg, dev)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in next(iter(trainlib.build_dataset(cfg))).items()}
    loss_fn = trainlib.build_loss(cfg, state)
    table = state.params["embedding.embedding"]
    grads = {}
    for impl in ("matmul", "scatter"):
        state.model.embedding.grad_impl = impl
        gen = torch.Generator(device=dev).manual_seed(cfg.seed)
        loss, _ = loss_fn(state.params, state, batch, {"dropout": gen})
        grads[impl], = torch.autograd.grad(loss, [table])
    state.model.embedding.grad_impl = "auto"
    a, b = grads["matmul"].float(), grads["scatter"].float()
    scale = float(b.abs().max())
    err = (a - b).abs()
    ok = bool((err <= EMBED_RTOL * b.abs() + EMBED_ATOL_OF_SCALE * scale)
              .all())
    V, d = table.shape
    n = batch["inputs"].numel()
    g = torch.randn(n, d, device=dev).bfloat16()
    flat = batch["inputs"].reshape(-1)

    def scatter():
        t = torch.zeros(V, d, dtype=torch.float32, device=dev)
        t.index_add_(0, flat, g.float())
        return t

    ms = {"matmul": time_ms(lambda: embed._one_hot_matmul_grad(
        flat, g, V, 2048), 10), "scatter": time_ms(scatter, 10)}
    log(f"embedding gradient, DTM_EMBED_GRAD=matmul against scatter on one "
        f"transformer_lm step ({n} tokens, V {V}, d {d}): max abs diff "
        f"{float(err.max()):.3g} (scale {scale:.3g}; bound one bf16 ulp + "
        f"{EMBED_ATOL_OF_SCALE:g} of the scale); backward alone: one-hot "
        f"matmul {ms['matmul']:.3f} ms, index_add_ {ms['scatter']:.3f} ms "
        f"(events) | {card}")
    if not ok:
        fail(f"the matmul embedding gradient differs from the scatter's by "
             f"{float(err.max()):.3g}")
    return {"max_abs_diff": float(err.max()), "ms": ms}


def _blockq_check(seed: int, card: str) -> dict:
    """Blockwise attention with ``block_q`` against the unchunked loop at
    ``BLOCKQ_SHAPE`` causal in bf16: output and the three gradients; both
    timed (forward and backward)."""
    import numpy as np
    import torch

    from distributed_tensorflow_models_tpu_torch.ops import attention as attnlib

    rng = np.random.default_rng(seed)

    def bf16():
        return torch.from_numpy(rng.standard_normal(
            BLOCKQ_SHAPE, dtype=np.float32)).cuda().bfloat16()

    qkv = [bf16().requires_grad_() for _ in range(3)]
    do = bf16()

    def run(bq):
        out = attnlib.blockwise_attention(*qkv, causal=True, block_q=bq)
        return (out, *torch.autograd.grad(out, qkv, do))

    res = {bq: run(bq) for bq in (None, BLOCKQ)}
    worst = 0.0
    for name, a, b in zip(("out", "dq", "dk", "dv"), res[BLOCKQ], res[None]):
        a, b = a.detach().float(), b.detach().float()
        scale = float(b.abs().max())
        err = (a - b).abs()
        worst = max(worst, float(err.max()) / scale)
        if not bool((err <= BLOCKQ_RTOL * b.abs()
                     + BLOCKQ_ATOL_OF_SCALE * scale).all()):
            fail(f"blockwise block_q={BLOCKQ} {name}: max abs err "
                 f"{float(err.max()):.3g} (scale {scale:.3g})")
    del res
    torch.cuda.empty_cache()
    ms = {str(bq): time_ms(lambda bq=bq: run(bq), 3, warmup=1)
          for bq in (None, BLOCKQ)}
    log(f"blockwise attention at B{BLOCKQ_SHAPE[0]} T{BLOCKQ_SHAPE[1]} "
        f"H{BLOCKQ_SHAPE[2]} D{BLOCKQ_SHAPE[3]} causal bf16, block_q="
        f"{BLOCKQ} against the unchunked loop: output and gradients within "
        f"one bf16 ulp + {BLOCKQ_ATOL_OF_SCALE:g} of the scale (largest "
        f"error {worst:.3g} of the scale); forward + backward "
        f"{ms['None']:.2f} ms unchunked, {ms[str(BLOCKQ)]:.2f} ms chunked "
        f"(events) | {card}")
    return {"ms": ms, "worst_of_scale": worst}


def phase_model_knobs(card: str, workdir: Path, flash_fns: dict, k1, k6,
                      batch: int, seed: int) -> dict:
    """Phase 16: ``transformer_lm_moe`` through ``fit`` against its eager
    steps and beside ``transformer_lm``; remat on the transformer, on
    ResNet-50 and on Inception-v3 against the same run without it;
    ``moe_ffn`` on the card against the CPU; ``DTM_EMBED_GRAD=matmul``
    against ``scatter``; blockwise ``block_q`` against the unchunked
    loop."""
    import torch

    from distributed_tensorflow_models_tpu_torch.harness.config import get_config
    from distributed_tensorflow_models_tpu_torch.ops import conv as convlib

    t_phase = time.perf_counter()
    steps = KNOB_STEPS
    os.environ["DTM_FLASH_BWD"] = "pair"
    out = {}
    lm_kids = ("K2", "K3", "K4")

    def counts():
        return {kid: fn.launches for kid, fn in flash_fns.items()}

    # (a) transformer_lm_moe on flash, captured, against its eager steps.
    moe_cfg = get_config("transformer_lm_moe", attn_impl="flash",
                         train_steps=steps)
    layers = moe_cfg.model_kwargs["num_layers"]
    tokens = moe_cfg.global_batch_size * moe_cfg.num_steps
    want_losses, eager = _eager_run(moe_cfg, steps)
    zero_counts(flash_fns.values())
    moe_run = run_fit(moe_cfg, workdir / "moe", keep=True)
    got = counts()
    want = {kid: layers * steps if kid in lm_kids else 0 for kid in got}
    log(f"transformer_lm_moe: flash launches {got} (expected {want})")
    if got != want:
        fail(f"transformer_lm_moe launched {got}, expected {want}")
    out["moe_launches"] = got
    r = moe_run.pop("fit")
    _lm_states_close("transformer_lm_moe, replayed against eager",
                     moe_run["losses"], want_losses, state_tensors(r.state),
                     eager, card)
    aux = [row["aux_loss"] for row in r.history]
    if not all(math.isfinite(v) and v > 0 for v in aux):
        fail(f"transformer_lm_moe aux losses {aux}")
    log(f"transformer_lm_moe: aux losses {aux}; FLOPs a step "
        f"{_flops_of(r):.4g}")
    del r, eager
    out["moe"] = _moe_check(moe_cfg, seed, card)

    # (b) transformer_lm on flash, dropout 0.1, remat off and on.
    dense = get_config("transformer_lm", attn_impl="flash")
    lm = {}
    for label, remat in (("off", False), ("on", True)):
        cfg = dense.replace(train_steps=steps, model_kwargs={
            **dense.model_kwargs, "remat": remat})
        zero_counts(flash_fns.values())
        run = run_fit(cfg, workdir / f"lm_remat_{label}", keep=True)
        run["launches"] = counts()
        lm[label] = run
    k2_step = {label: lm[label]["launches"]["K2"] / steps for label in lm}
    for label, k2_times in (("off", 1), ("on", 2)):
        want = {kid: (k2_times if kid == "K2" else 1) * layers * steps
                if kid in lm_kids else 0 for kid in flash_fns}
        if lm[label]["launches"] != want:
            fail(f"transformer_lm with remat {label} launched "
                 f"{lm[label]['launches']}, expected {want}")
    out["remat_lm_launches"] = lm["on"]["launches"]
    _lm_states_close("transformer_lm remat on against off",
                     lm["on"]["losses"], lm["off"]["losses"],
                     state_tensors(lm["on"]["fit"].state),
                     state_tensors(lm["off"]["fit"].state), card)
    flops = {label: _flops_of(lm[label]["fit"]) for label in lm}
    log(f"transformer_lm K2 launches a step: remat off {k2_step['off']:g}, "
        f"on {k2_step['on']:g}; FLOPs a step counted: off {flops['off']:.4g},"
        f" on {flops['on']:.4g} (the recomputed forward included)")
    for label, r in (("moe", moe_run), ("remat off", lm["off"]),
                     ("remat on", lm["on"])):
        log_arm(f"LM {label}", r, tokens, card)
        r.pop("fit", None)
    out["lm_flops"] = flops

    # (c) ResNet-50 and Inception-v3 on K1, remat off and on: the BN
    # running statistics after the run bit for bit.
    convlib.set_default_conv_impl("mxu")
    os.environ["DTM_CONV_MXU_PIPELINE"] = "0"
    for name, config, b in (("ResNet-50", "resnet50_synthetic", batch),
                            ("Inception-v3", "inception_v3_imagenet",
                             KNOB_INCEPTION_BATCH)):
        runs = {}
        for label, remat in (("off", False), ("on", True)):
            base = get_config(config)
            cfg = base.replace(train_steps=steps, global_batch_size=b,
                               model_kwargs={**base.model_kwargs,
                                             "remat": remat})
            zero_counts((k1, k6))
            run = run_fit(cfg, workdir / f"{config}_remat_{label}",
                          keep=True)
            run["k1"] = (k1.launches, k6.launches)
            runs[label] = run
        a, c = runs["on"]["fit"].state, runs["off"]["fit"].state
        stats_same = sum(bool(torch.equal(a.batch_stats[k],
                                          c.batch_stats[k]))
                         for k in c.batch_stats)
        sa, sc = state_tensors(a), state_tensors(c)
        same = sum(bool(torch.equal(x, y)) for x, y in zip(sa, sc))
        per_step = {label: runs[label]["k1"][0] / steps for label in runs}
        log(f"{name} remat on against off at batch {b}: {stats_same} of "
            f"{len(c.batch_stats)} BN statistics equal bit for bit, {same} "
            f"of {len(sc)} state tensors; losses on {runs['on']['losses']}, "
            f"off {runs['off']['losses']}; K1 launches a step: off "
            f"{per_step['off']:g}, on {per_step['on']:g}; FLOPs a step "
            f"counted: off {_flops_of(runs['off']['fit']):.4g}, on "
            f"{_flops_of(runs['on']['fit']):.4g} | {card}")
        if stats_same != len(c.batch_stats) or not per_step["on"] > \
                per_step["off"] or runs["on"]["k1"][1] or runs["off"]["k1"][1]:
            fail(f"{name} remat: {stats_same} of {len(c.batch_stats)} BN "
                 f"statistics equal, K1/K6 launches {runs['on']['k1']} on "
                 f"and {runs['off']['k1']} off")
        for label in ("off", "on"):
            runs[label].pop("fit")
            log_arm(f"{name} remat {label}", runs[label], b, card)
        out[f"remat_{config}"] = {"k1_launches": runs["on"]["k1"][0],
                                  "per_step": per_step, "batch": b}
        del a, c, sa, sc, runs

    # (d) and (e).
    out["embed"] = _embed_check(card)
    out["blockq"] = _blockq_check(seed + 1, card)
    log(f"model knobs phase: {time.perf_counter() - t_phase:.1f} s")
    return out


# Phase 17: the ring's per-rank arithmetic at FLASH_SHAPES (b) and (c)
# over n virtual ranks, the restored transformer_tp + ring fit at axes of
# one, and cnn_tp's split convolutions.
PAR_SHAPES = (
    # name, B, T, H, Hkv, D, causal, window
    ("b", 4, 2048, 8, 8, 64, True, None),
    ("c", 4, 2048, 8, 2, 32, True, 256),
)
PAR_RINGS = (2, 4)
PAR_STEPS = 8
PAR_TIME_ITERS = 5


def _ring_check(shape, n: int, seed: int, flash_fns: dict, card: str,
                full: dict) -> dict:
    """``parallel/ring.py::emulate`` (``ring_step`` per virtual rank, the
    KV blocks in the order each rank receives them, K2 forward and K3 + K4
    backward per block) against the full ``flash_attention`` and the plain
    ``reference_attention`` on the same inputs; K2-K4 launches counted
    over one emulated call (n per virtual rank each); the emulated ring's
    forward and backward timed against one full flash call's."""
    import torch

    from distributed_tensorflow_models_tpu_torch.parallel import ring as ringlib

    name, B, T, H, Hkv, D, causal, window = shape
    q, k, v, do = full["inputs"]
    zero_counts(flash_fns.values())
    out, dq, dk, dv = ringlib.emulate(q, k, v, n, impl="flash", causal=causal,
                                      window=window, dout=do)
    torch.cuda.synchronize()
    launches = {kid: fn.launches for kid, fn in flash_fns.items()}
    want = {kid: n * n if kid in ("K2", "K3", "K4") else 0
            for kid in flash_fns}
    if launches != want:
        fail(f"ring ({name}, n={n}): launches {launches}, expected {want}")
    for t, what in ((out, "out"), (dq, "dq"), (dk, "dk"), (dv, "dv")):
        if not bool(torch.isfinite(t).all()):
            fail(f"ring ({name}, n={n}): {what} is not finite")
    errs = {}
    for ref in ("flash", "reference"):
        for what, got, want_t in zip(("out", "dq", "dk", "dv"),
                                     (out, dq, dk, dv), full[ref]):
            errs[f"{what} vs {ref}"] = _flash_err(
                f"ring ({name}, n={n}) {what} against the full {ref}", got,
                want_t)
    masked = sum(ringlib.fully_masked(i * (T // n), ((i - r) % n) * (T // n),
                                      T // n, T // n, causal, window)
                 for i in range(n) for r in range(n))
    ring_fwd = time_ms(lambda: ringlib.emulate(
        q, k, v, n, impl="flash", causal=causal, window=window),
        PAR_TIME_ITERS, 1)
    ring_all = time_ms(lambda: ringlib.emulate(
        q, k, v, n, impl="flash", causal=causal, window=window, dout=do),
        PAR_TIME_ITERS, 1)
    log(f"ring ({name}: B{B} T{T} H{H} Hkv{Hkv} D{D}"
        f"{' window ' + str(window) if window else ''}), n={n} virtual "
        f"ranks ({T // n} tokens each, {masked} of {n * n} blocks wholly "
        f"masked): K2/K3/K4 {n * n} launches each; max abs err "
        + ", ".join(f"{k_} {v_:.4g}" for k_, v_ in errs.items())
        + f"; the n-rank ring body {ring_fwd:.3f} ms forward, "
        f"{ring_all - ring_fwd:.3f} ms backward (its recompute-free "
        f"autograd), against one full flash_attention {full['fwd_ms']:.3f} "
        f"and {full['bwd_ms']:.3f} ms | {card}")
    return {"launches": launches, "max_abs_err": max(errs.values()),
            "fwd_ms": ring_fwd, "bwd_ms": ring_all - ring_fwd,
            "masked_blocks": masked}


def _full_attention(shape, seed: int) -> dict:
    """The shape's bf16 inputs and the full ``flash_attention`` (K2-K4)
    and plain ``reference_attention`` outputs and gradients, the flash
    call timed per direction."""
    import numpy as np
    import torch

    from distributed_tensorflow_models_tpu_torch.ops import attention as attnlib

    _, B, T, H, Hkv, D, causal, window = shape
    rng = np.random.default_rng(seed)

    def bf16(*dims):
        return torch.from_numpy(rng.standard_normal(
            dims, dtype=np.float32)).cuda().bfloat16()

    q, do = bf16(B, T, H, D), bf16(B, T, H, D)
    k, v = bf16(B, T, Hkv, D), bf16(B, T, Hkv, D)
    out = {"inputs": (q, k, v, do)}
    for ref, fn in (("flash", lambda a, b, c: attnlib.flash_attention(
            a, b, c, causal, None, None, None, window)),
                    ("reference", lambda a, b, c: attnlib.reference_attention(
                        a, b, c, causal=causal, window=window))):
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        o = fn(*leaves)
        o.backward(do)
        out[ref] = (o.detach(), *(t.grad for t in leaves))
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]

    def fwd():
        return attnlib.flash_attention(*leaves, causal, None, None, None,
                                       window)

    def both():
        fwd().backward(do)

    out["fwd_ms"] = time_ms(fwd, PAR_TIME_ITERS, 1)
    out["bwd_ms"] = time_ms(both, PAR_TIME_ITERS, 1) - out["fwd_ms"]
    return out


def phase_parallel(card: str, workdir: Path, flash_fns: dict, k1,
                   batch: int, seed: int) -> dict:
    """Phase 17: tensor and sequence parallelism on the card, where one
    GPU holds one rank.  (a) The ring's per-rank arithmetic at full width:
    ``ring.emulate`` at shapes (b) and (c) for n = 2 and 4 virtual ranks
    against the full flash kernels and the plain reference; (b) ``fit`` of
    ``transformer_lm`` with its ``param_rules="transformer_tp"`` and
    ``seq_impl="ring"`` at model and seq axes of one (flash, dropout 0.1,
    a world-1 NCCL group, 8 steps in chunks of 4, captured) in turns with
    the same fit without rules or ``seq_impl``: the same collectives a
    step, one capture a fit, K2/K3/K4 at 4 launches a step, the states
    within the LM bound; (c) ``cnn_tp``'s split convolutions: K1 on each
    half of the output channels of every ResNet-50 launch shape,
    concatenated, against K1 on all of them."""
    import socket

    import numpy as np
    import torch
    import torch.distributed as dist

    from distributed_tensorflow_models_tpu_torch import launch
    from distributed_tensorflow_models_tpu_torch.core import sharding
    from distributed_tensorflow_models_tpu_torch.harness import train as trainlib
    from distributed_tensorflow_models_tpu_torch.harness.config import get_config
    from distributed_tensorflow_models_tpu_torch.ops import conv_mxu

    t_phase = time.perf_counter()
    os.environ["DTM_FLASH_BWD"] = "pair"
    out = {"ring": {}}

    # (a) The ring's per-rank arithmetic.
    for i, shape in enumerate(PAR_SHAPES):
        full = _full_attention(shape, seed + i)
        for n in PAR_RINGS:
            out["ring"][(shape[0], n)] = _ring_check(shape, n, seed + i,
                                                     flash_fns, card, full)
        del full
        torch.cuda.empty_cache()
    ring_launches = {kid: sum(r["launches"][kid] for r in
                              out["ring"].values()) for kid in flash_fns}

    # (b) The restored rule set and the ring at axes of one, in a world-1
    # NCCL group, in turns with the plain fit.
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = {launch.ENV_COORDINATOR: f"127.0.0.1:{port}",
           launch.ENV_NUM_PROCESSES: "1", launch.ENV_PROCESS_ID: "0"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    lm = get_config("transformer_lm", attn_impl="flash",
                    train_steps=PAR_STEPS)
    if lm.param_rules != "transformer_tp":
        fail(f"transformer_lm's param_rules are {lm.param_rules!r}")
    layers = lm.model_kwargs["num_layers"]
    tokens = lm.global_batch_size * lm.num_steps
    arms = []
    try:
        if not launch.initialize_from_env():
            fail("parallel: initialize_from_env found no cluster")
        try:
            for label in ("tp + ring", "plain", "tp + ring", "plain"):
                cfg = (lm.replace(seq_impl="ring") if label != "plain"
                       else lm.replace(param_rules="", seq_impl=None))
                mesh = trainlib.mesh_from_config(cfg)
                if (mesh.shape["model"], mesh.shape["seq"], mesh.backend) != (
                        1, 1, "nccl"):
                    fail(f"parallel: mesh {mesh.shape} over {mesh.backend}")
                zero_counts(flash_fns.values())
                before = sharding.collective_counts()
                r = run_fit(cfg, workdir / f"lm{len(arms)}", mesh=mesh,
                            keep=True)
                r["collectives"] = sharding.counts_since(before)
                r["launches"] = {kid: fn.launches
                                 for kid, fn in flash_fns.items()}
                want = {kid: layers * PAR_STEPS if kid in ("K2", "K3", "K4")
                        else 0 for kid in flash_fns}
                if r["launches"] != want:
                    fail(f"parallel, {label}: launches {r['launches']}, "
                         f"expected {want}")
                if len(arms) < 2:
                    r["state"] = [t.cpu() for t in
                                  state_tensors(r["fit"].state)]
                r.pop("fit")
                arms.append((label, r))
        finally:
            dist.destroy_process_group()
    finally:
        for key, val in saved.items():
            if val is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = val
    counts = [{site: n for site, (n, _) in r["collectives"].items()}
              for _, r in arms]
    if any(c != counts[1] for c in counts) or any(
            "/" in site for site in counts[0]):
        fail(f"parallel: collectives {counts}: the axes of one must add "
             f"none")
    ring_state, plain_state = arms[0][1].pop("state"), arms[1][1].pop("state")
    _lm_states_close("transformer_lm, transformer_tp + ring at axes of one "
                     "against the plain fit", arms[0][1]["losses"],
                     arms[1][1]["losses"], ring_state, plain_state, card)
    same = sum(bool(torch.equal(a, b)) for a, b in zip(ring_state,
                                                       plain_state))
    out["fit"] = {"launches": arms[0][1]["launches"], "same": same,
                  "tensors": len(ring_state),
                  "losses_equal": arms[0][1]["losses"] == arms[1][1][
                      "losses"],
                  "collectives": counts[0]}
    log(f"parallel fit: collectives a run {counts[0]} on every arm "
        f"({PAR_STEPS} steps); K2/K3/K4 {layers} launches a step; "
        f"{same} of {len(ring_state)} state tensors bit for bit, losses "
        f"{'equal' if out['fit']['losses_equal'] else 'differ'} | {card}")
    for label, r in arms:
        log_arm(f"LM {label}", r, tokens, card)
    del ring_state, plain_state

    # (c) cnn_tp's split convolutions: K1 on each half of the output
    # channels against K1 on all of them.
    calls = core_launch_shapes("resnet50", 224, batch)
    shapes = sorted({(xs, ks) for _, xs, ks in calls})
    rng = np.random.default_rng(seed + 9)
    zero_counts((k1,))
    equal, worst = 0, 0.0
    for xs, ks in shapes:
        x = torch.from_numpy(rng.standard_normal(xs).astype("float32")
                             ).cuda().bfloat16()
        w = (torch.from_numpy(rng.standard_normal(ks).astype("float32"))
             / math.sqrt(ks[0] * ks[1] * ks[2])).cuda().bfloat16()
        whole = conv_mxu.conv_implicit_gemm(x, w)
        c = ks[3] // 2
        halves = torch.cat([conv_mxu.conv_implicit_gemm(
            x, w[..., :c].contiguous()), conv_mxu.conv_implicit_gemm(
            x, w[..., c:].contiguous())], dim=-1)
        torch.cuda.synchronize()
        if torch.equal(halves, whole):
            equal += 1
        worst = max(worst, float((halves.float() - whole.float()).abs().max()))
        del x, w, whole, halves
    split_launches = k1.launches
    if equal != len(shapes):
        fail(f"cnn_tp: K1 on halves of the output channels differs from K1 "
             f"on all at {len(shapes) - equal} of {len(shapes)} shapes (max "
             f"abs {worst:.4g})")
    # The routing rule (conv_mxu._use_mxu_kernel) reads the kernel's kh,
    # kw and Cin and not Cout, so a split of Cout moves no conv off K1.
    log(f"cnn_tp: K1 on each half of the output channels, concatenated, "
        f"equals K1 on all of them bit for bit at all {len(shapes)} "
        f"ResNet-50 launch shapes ({split_launches} launches); "
        f"_use_mxu_kernel does not read Cout, so no conv leaves K1 at "
        f"Cout/2; at model=2 a ResNet-50 step launches K1 {len(calls)} "
        f"times a process, each on half the output channels | {card}")
    out["cnn_tp"] = {"launches": split_launches, "shapes": len(shapes)}
    out["ring_launches"] = ring_launches
    log(f"parallel phase: {time.perf_counter() - t_phase:.1f} s")
    return out


# Phase 18: the pipelined stack's schedule at n virtual stages and m
# microbatches, the pipelined fit at a pipe axis of one, the expert
# layout's per-rank arithmetic and the MoE fit at an expert axis of one.
PIPE_STAGES = (2, 4)
PIPE_MICRO = (4, 8)
PIPE_FIT_MICRO = 4
EXPERT_RANKS = (2, 4)


def _pipeline_check(stack, n: int, m: int, seed: int, flash_fns: dict,
                    card: str) -> dict:
    """``PipelinedBlocks.emulate`` (the pipelined schedule of ``n``
    virtual stages) against the stack's sequential schedule on the same
    weights, input, output cotangent and dropout bits, at ``m``
    microbatches: the output and the gradients of the input and of every
    stacked parameter within the K2-K4 tolerance; K2/K3/K4 launches
    counted over the emulated forward and backward (one a layer a
    microbatch each)."""
    import torch

    stack.num_microbatches = m
    g = torch.Generator(device="cuda").manual_seed(seed)
    d = stack.wq.shape[1]
    x = torch.randn((16, 256, d), generator=g, device="cuda").bfloat16()
    dy = torch.randn((16, 256, d), generator=g, device="cuda").bfloat16()
    params = list(stack.parameters())

    def run(emulated: bool):
        xs = x.clone().requires_grad_()
        rngs = {"dropout": torch.Generator(device="cuda").manual_seed(seed)}
        y = (stack.emulate(xs, n, True, rngs) if emulated
             else stack(xs, True, rngs))
        grads = torch.autograd.grad(y, [xs, *params], dy)
        return [y.detach(), *grads]

    want = run(False)
    zero_counts(flash_fns.values())
    got = run(True)
    torch.cuda.synchronize()
    launches = {kid: fn.launches for kid, fn in flash_fns.items()}
    expect = {kid: stack.num_layers * m if kid in ("K2", "K3", "K4") else 0
              for kid in flash_fns}
    if launches != expect:
        fail(f"pipeline emulation (n={n}, m={m}): launches {launches}, "
             f"expected {expect}")
    names = ["out", "dx"] + [f"d{k}" for k in stack.PARAMS]
    errs = {what: _flash_err(f"pipeline emulation (n={n}, m={m}) {what}",
                             a, b) for what, a, b in zip(names, got, want)}
    same = sum(bool(torch.equal(a, b)) for a, b in zip(got, want))
    log(f"pipeline emulation: {n} virtual stages, {m} microbatches of "
        f"{16 // m} rows (B16 T256 d{d}, bf16, flash, dropout "
        f"{stack.dropout_rate}): K2/K3/K4 {stack.num_layers * m} launches "
        f"each; {same} of {len(names)} outputs and gradients bit for bit "
        f"against the sequential schedule, max abs err "
        + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()) + f" | {card}")
    return {"launches": launches, "max_abs_err": max(errs.values()),
            "same": same}


def _expert_check(params, x, ranks: int, card: str) -> dict:
    """``moe.emulate`` (the expert layout's per-rank arithmetic for
    ``ranks`` virtual expert ranks) against ``moe_ffn_reference(num_ranks
    =ranks)`` on the card: out, aux, the dropped fraction, and the
    gradients of ``mean(out**2) + 0.01 * aux`` for the tokens and every
    parameter; both timed forward."""
    import torch

    from distributed_tensorflow_models_tpu_torch.parallel import moe

    runs = []
    for fn in (moe.emulate, moe.moe_ffn_reference):
        p = {k: v.clone().requires_grad_() for k, v in params.items()}
        xs = x.clone().requires_grad_()
        r = fn(p, xs, num_ranks=ranks)
        loss = torch.mean(r.out ** 2) + 0.01 * r.aux_loss
        grads = torch.autograd.grad(loss, [xs, *p.values()])
        runs.append(([r.out.detach(), *grads], float(r.aux_loss.detach()),
                     float(r.dropped_fraction)))
    (got, aux, drop), (want, aux_ref, drop_ref) = runs
    worst = 0.0
    for what, a, b in zip(("out", "dx", "drouter", "dw_in", "dw_out"), got,
                          want):
        scale = float(b.abs().max())
        err = (a - b).abs()
        if not bool((err <= MOE_RTOL * b.abs()
                     + MOE_ATOL_OF_SCALE * scale).all()):
            fail(f"expert emulation ({ranks} ranks) {what}: max abs err "
                 f"{float(err.max()):.3g} at scale {scale:.3g}")
        worst = max(worst, float(err.max()) / max(scale, 1e-30))
    if abs(aux - aux_ref) > MOE_SCALAR_TOL or abs(drop - drop_ref) > \
            MOE_SCALAR_TOL:
        fail(f"expert emulation ({ranks} ranks): aux {aux} against {aux_ref}"
             f", dropped {drop} against {drop_ref}")
    ms = {name: time_ms(lambda fn=fn: fn(params, x, num_ranks=ranks),
                        PAR_TIME_ITERS, 1)
          for name, fn in (("emulated", moe.emulate),
                           ("reference", moe.moe_ffn_reference))}
    log(f"expert emulation: {ranks} virtual expert ranks over "
        f"{x.shape[0]} tokens (d {x.shape[1]}, f {params['w_in'].shape[2]}, "
        f"{params['w_in'].shape[0]} experts, f32): out and gradients within "
        f"rtol {MOE_RTOL} + {MOE_ATOL_OF_SCALE} of scale of "
        f"moe_ffn_reference(num_ranks={ranks}) (largest error {worst:.3g} "
        f"of scale); aux {aux:.6f} ({aux_ref:.6f}), dropped {drop:.6f} "
        f"({drop_ref:.6f}); forward {ms['emulated']:.3f} ms emulated, "
        f"{ms['reference']:.3f} ms the reference (events) | {card}")
    return {"rel_err": worst, "aux": aux, "dropped": drop, **ms}


def _sum_check(mesh, card: str) -> dict:
    """In the world-1 NCCL group: one all-reduce of a seeded 4096-element
    tensor in f32, bf16 and f16 by NCCL's sum pre-multiplied by 1
    (printed: the card's NCCL gave zeros for bf16, F8) and by the port's
    ``sharding.all_reduce_sum_``, which must leave each unchanged."""
    import torch
    import torch.distributed as dist

    from distributed_tensorflow_models_tpu_torch.core import sharding

    base = torch.randn(4096, generator=torch.Generator(
        device="cuda").manual_seed(0), device="cuda")
    out = {}
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        x = base.to(dtype)
        raw = x.clone()
        dist.all_reduce(raw, op=dist._make_nccl_premul_sum(1.0),
                        group=mesh.dp_group)
        ours = sharding.all_reduce_sum_(x.clone(), mesh, "sum_check",
                                        dp=True)
        torch.cuda.synchronize()
        ratio = (raw.float() / x.float())[x.float().abs() > 1e-3]
        out[str(dtype)] = {"premul_equal": bool(torch.equal(raw, x)),
                           "premul_ratio": (float(ratio.min()),
                                            float(ratio.max())),
                           "port_equal": bool(torch.equal(ours, x))}
        log(f"world-1 NCCL sum of a {dtype} tensor: pre-multiplied by 1 "
            f"{'unchanged' if out[str(dtype)]['premul_equal'] else 'changed'}"
            f" (result / input {float(ratio.min()):.6g} to "
            f"{float(ratio.max()):.6g}); "
            f"the port's all_reduce_sum_ "
            f"{'unchanged' if out[str(dtype)]['port_equal'] else 'CHANGED'}"
            f" | {card}")
        if not out[str(dtype)]["port_equal"]:
            fail(f"the port's world-1 NCCL sum changed a {dtype} tensor")
    return out


def phase_pipe_expert(card: str, workdir: Path, flash_fns: dict,
                      seed: int) -> dict:
    """Phase 18: pipeline and expert parallelism on the card, where one
    GPU holds one rank.  (a) The pipelined ``transformer_lm`` stack at
    full width: its schedule emulated at 2 and 4 virtual stages and 4 and
    8 microbatches against its sequential schedule.  (b) ``fit`` of
    ``transformer_lm`` pipelined (pipe 1, 4 microbatches, flash, dropout
    0.1, a world-1 NCCL group, ``PAR_STEPS`` steps in chunks of 4,
    captured) in turns with the plain fit: K2/K3/K4 at layers x
    microbatches a step, no ``pipe/*`` collective, replay against the
    eager steps, tokens/s of both.  (c) The expert layout's per-rank
    arithmetic at ``transformer_lm_moe``'s width against
    ``moe_ffn_reference(num_ranks=E)``, E = 2 and 4; ``fit`` of
    ``transformer_lm_moe`` at expert 1 in the NCCL group against the plain
    fit (phase 16's path)."""
    import socket

    import numpy as np
    import torch
    import torch.distributed as dist

    from distributed_tensorflow_models_tpu_torch import launch
    from distributed_tensorflow_models_tpu_torch.core import sharding
    from distributed_tensorflow_models_tpu_torch.harness import train as trainlib
    from distributed_tensorflow_models_tpu_torch.harness.config import get_config
    from distributed_tensorflow_models_tpu_torch.parallel import moe

    t_phase = time.perf_counter()
    os.environ["DTM_FLASH_BWD"] = "pair"
    out = {"pipe": {}, "expert": {}}
    base = get_config("transformer_lm", attn_impl="flash",
                      train_steps=PAR_STEPS)
    layers = base.model_kwargs["num_layers"]
    tokens = base.global_batch_size * base.num_steps
    piped = base.replace(model_kwargs={
        **base.model_kwargs, "pipelined": True,
        "pipeline_microbatches": PIPE_FIT_MICRO})

    # (a) The pipelined schedule's arithmetic.
    model = trainlib.build_model(piped, torch.device("cuda"))
    for n in PIPE_STAGES:
        for m in PIPE_MICRO:
            out["pipe"][(n, m)] = _pipeline_check(model.pipeline, n, m,
                                                  seed + n + m, flash_fns,
                                                  card)
    del model
    torch.cuda.empty_cache()
    emu_launches = {kid: sum(r["launches"][kid]
                             for r in out["pipe"].values())
                    for kid in flash_fns}

    # (b) The pipelined fit at a pipe axis of one in a world-1 NCCL group,
    # in turns with the plain fit; (c)'s MoE fit at an expert axis of one.
    want_losses, eager = _eager_run(piped, PAR_STEPS)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = {launch.ENV_COORDINATOR: f"127.0.0.1:{port}",
           launch.ENV_NUM_PROCESSES: "1", launch.ENV_PROCESS_ID: "0"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    moe_cfg = get_config("transformer_lm_moe", attn_impl="flash",
                         train_steps=PAR_STEPS)
    arms = []
    try:
        if not launch.initialize_from_env():
            fail("pipe/expert: initialize_from_env found no cluster")
        try:
            for label in ("pipelined", "plain", "pipelined", "plain"):
                cfg = piped if label == "pipelined" else base
                mesh = trainlib.mesh_from_config(cfg)
                if (mesh.shape["pipe"], mesh.backend) != (1, "nccl"):
                    fail(f"pipe/expert: mesh {mesh.shape} over "
                         f"{mesh.backend}")
                zero_counts(flash_fns.values())
                before = sharding.collective_counts()
                r = run_fit(cfg, workdir / f"lm{len(arms)}", mesh=mesh,
                            keep=True)
                r["collectives"] = sharding.counts_since(before)
                r["launches"] = {kid: fn.launches
                                 for kid, fn in flash_fns.items()}
                per = PIPE_FIT_MICRO if label == "pipelined" else 1
                want = {kid: layers * per * PAR_STEPS
                        if kid in ("K2", "K3", "K4") else 0
                        for kid in flash_fns}
                if r["launches"] != want:
                    fail(f"pipe/expert, {label}: launches {r['launches']}, "
                         f"expected {want}")
                if not arms:
                    r["state"] = [t.cpu() for t in
                                  state_tensors(r["fit"].state)]
                r.pop("fit")
                arms.append((label, r))
            zero_counts(flash_fns.values())
            mesh = trainlib.mesh_from_config(moe_cfg)
            if mesh.shape["expert"] != 1:
                fail(f"pipe/expert: mesh {mesh.shape}")
            before = sharding.collective_counts()
            moe_group = run_fit(moe_cfg, workdir / "moe_group", mesh=mesh,
                                keep=True)
            moe_group["collectives"] = sharding.counts_since(before)
            moe_group["launches"] = {kid: fn.launches
                                     for kid, fn in flash_fns.items()}
            moe_group["state"] = [t.cpu() for t in
                                  state_tensors(moe_group.pop("fit").state)]
            out["sums"] = _sum_check(mesh, card)
        finally:
            dist.destroy_process_group()
    finally:
        for key, val in saved.items():
            if val is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = val
    counts = [{site: n for site, (n, _) in r["collectives"].items()}
              for _, r in arms]
    if any(c != counts[1] for c in counts) or any(
            site.startswith("pipe/") for site in counts[0]):
        fail(f"pipe/expert: collectives {counts}: a pipe axis of one must "
             f"add none")
    piped_state = arms[0][1].pop("state")
    same = sum(bool(torch.equal(a, b.cpu())) for a, b in zip(piped_state,
                                                             eager))
    _lm_states_close("transformer_lm pipelined, replayed against eager",
                     arms[0][1]["losses"], want_losses, piped_state,
                     [t.cpu() for t in eager], card)
    out["fit"] = {"launches": arms[0][1]["launches"], "same": same,
                  "tensors": len(piped_state), "collectives": counts[0],
                  "losses_equal": arms[0][1]["losses"] == want_losses}
    log(f"pipelined fit (pipe 1, {PIPE_FIT_MICRO} microbatches): "
        f"collectives a run {counts[0]} on every arm ({PAR_STEPS} steps), "
        f"no pipe/*; K2/K3/K4 {layers * PIPE_FIT_MICRO} launches a step "
        f"(plain {layers}); replay against eager: {same} of "
        f"{len(piped_state)} state tensors bit for bit, losses "
        f"{'equal' if out['fit']['losses_equal'] else 'differ'} | {card}")
    for label, r in arms:
        log_arm(f"LM {label}", r, tokens, card)
    del piped_state, eager

    # (c) The expert layout's per-rank arithmetic at transformer_lm_moe's
    # width, and the MoE fit at expert 1 against the plain fit.
    kw = moe_cfg.model_kwargs
    n_tok = moe_cfg.global_batch_size * moe_cfg.num_steps
    params = {k: v.cuda() for k, v in moe.init_moe_params(
        kw["num_experts"], kw["d_model"], kw["d_ff"],
        torch.Generator().manual_seed(seed)).items()}
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (n_tok, kw["d_model"]), dtype=np.float32)).cuda()
    for ranks in EXPERT_RANKS:
        out["expert"][ranks] = _expert_check(params, x, ranks, card)
    del params, x
    zero_counts(flash_fns.values())
    moe_plain = run_fit(moe_cfg, workdir / "moe_plain", keep=True)
    plain_state = [t.cpu() for t in state_tensors(moe_plain.pop("fit").state)]
    group_state = moe_group.pop("state")
    want = {kid: layers * PAR_STEPS if kid in ("K2", "K3", "K4") else 0
            for kid in flash_fns}
    if moe_group["launches"] != want:
        fail(f"transformer_lm_moe at expert 1: launches "
             f"{moe_group['launches']}, expected {want}")
    if any(site.startswith("expert/") for site in moe_group["collectives"]):
        fail(f"transformer_lm_moe at expert 1: collectives "
             f"{moe_group['collectives']}")
    _lm_states_close("transformer_lm_moe at expert 1 in a world-1 NCCL "
                     "group against the plain fit", moe_group["losses"],
                     moe_plain["losses"], group_state, plain_state, card)
    moe_same = sum(bool(torch.equal(a, b)) for a, b in zip(group_state,
                                                           plain_state))
    out["moe_fit"] = {"launches": moe_group["launches"], "same": moe_same,
                      "tensors": len(plain_state)}
    log(f"transformer_lm_moe at expert 1: {moe_same} of {len(plain_state)} "
        f"state tensors bit for bit with the plain fit; collectives "
        f"{ {k: n for k, (n, _) in moe_group['collectives'].items()} } | "
        f"{card}")
    for label, r in (("moe expert 1", moe_group), ("moe plain", moe_plain)):
        log_arm(f"LM {label}", r, tokens, card)
    out["emu_launches"] = emu_launches
    log(f"pipe/expert phase: {time.perf_counter() - t_phase:.1f} s")
    return out


AB_STEPS = 8
AB_WORKERS = 4
AB_LIMIT = 2
AB_BACKUP = (4, 3)  # total replicas M, replicas aggregated N
AB_LM_WORKERS = (1, 2)
AB_CLI_STEPS = 4
AB_CLI_WORKERS = 2


def _predicted_drops(workers: int, limit: int, events: int) -> tuple:
    """Round robin at a staleness limit, on the host: (staleness log,
    dropped flags)."""
    step, versions, log_, drops = 0, [0] * workers, [], []
    for e in range(events):
        w = e % workers
        stale = step - versions[w]
        log_.append(stale)
        drops.append(stale > limit)
        step += stale <= limit
        versions[w] = step
    return log_, drops


def _ab_log(label: str, res, per_step: int, unit: str, card: str) -> None:
    steps = len(res.sync_losses)
    log(f"A/B {label}: sync {res.sync_seconds:.3f} s "
        f"({per_step * steps / res.sync_seconds:.1f} {unit}/s), async "
        f"{res.async_seconds:.3f} s ({per_step * steps / res.async_seconds:.1f}"
        f" {unit}/s) over {steps} steps a mode, each closed by a device "
        f"sync; captures {res.capture_s}; staleness {res.staleness_log}, "
        f"mean {res.mean_staleness:.3f}, histogram {res.staleness_hist}, "
        f"dropped {res.dropped}; launches {res.launches}; sync losses "
        f"{res.sync_losses}; async losses {res.async_losses} | {card}")


def phase_async(card: str, flash_fns: dict, k1, k6, k1_per_step: int,
                batch: int) -> dict:
    """Phase 19: the reference's flagship async-PS vs sync A/B
    (``harness/experiment.py``) and its emulators (``parallel/async_ps.py``,
    ``parallel/backup.py``) on the card, every kernel counter zeroed at the
    phase's start and read at its end.  (a) ``async_vs_sync`` on
    ``resnet50_synthetic`` (full width, ``batch``, K1), ``AB_STEPS`` steps
    a mode: at K = 1 the async losses and every state tensor equal the sync
    mode's bit for bit; at K = 4 round robin the staleness ramps 0, 1, 2, 3
    and holds 3, and the async events equal the emulator run eagerly on
    the same batches bit for bit; at a staleness limit of 2 the drops are
    the host's prediction and the canonical step counts the applied
    events; K1 ``k1_per_step`` launches a step in the sync mode and an
    event in the async one.  (b) The backup emulator at M = 4, N = 3 on
    the batch's 64-row shards: the discarded shard zeroed leaves the state
    bit for bit, the BN statistics are one update from the canonical ones
    by the last chosen replica, K1 3 x ``k1_per_step`` launches a round.
    (c) ``async_vs_sync`` on ``transformer_lm`` (flash, K2-K4) at K = 1
    (async against sync within the LM bound: the embedding gradient's
    atomics) and K = 2, K2/K3/K4 one launch a layer a step and an event.
    (d) The CLI's ``ab`` in this process.  Each mode's seconds and rate,
    its capture seconds, the staleness profile and the peak memory are
    printed."""
    import numpy as np
    import torch

    from distributed_tensorflow_models_tpu_torch.core import mesh as meshlib
    from distributed_tensorflow_models_tpu_torch.core import train_loop
    from distributed_tensorflow_models_tpu_torch.harness import experiment
    from distributed_tensorflow_models_tpu_torch.harness import train as trainlib
    from distributed_tensorflow_models_tpu_torch.harness.config import get_config
    from distributed_tensorflow_models_tpu_torch.parallel import async_ps, backup

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    r50, lm = "resnet50_synthetic", "transformer_lm"
    out = {}
    k1_key = f"{k1.__name__}.launches"
    flash_keys = {kid: f"{fn.__name__}.launches"
                  for kid, fn in flash_fns.items()}

    def reset_peak() -> None:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    def check_launches(label, launches, want: dict) -> None:
        if launches != want:
            fail(f"{label}: launches {launches}, expected {want}")

    # One materialised batch stream per configuration, shared by its A/Bs
    # and emulator runs (the batches are only read).
    cache: dict = {}
    real_batches = experiment.ab_batches

    def ab_batches(cfg, steps, mesh):
        key = (cfg.name, cfg.global_batch_size, steps)
        if key not in cache:
            cache[key] = real_batches(cfg, steps, mesh)
        return cache[key]

    def fresh(cfg):
        mesh = trainlib.mesh_from_config(cfg, dev)
        state = train_loop.place_state(trainlib.build_state(
            cfg, dev, mesh, num_steps=max(cfg.train_steps, AB_STEPS)), mesh)
        return mesh, state

    zero_counts((k1, k6, *flash_fns.values()))
    experiment.ab_batches = ab_batches
    try:
        # (a) ResNet-50.
        cfg = get_config(r50, global_batch_size=batch)
        seed = cfg.seed + 1
        k1_run = {k1_key: k1_per_step * AB_STEPS}
        ab = {}
        for workers in (1, AB_WORKERS):
            reset_peak()
            res = experiment.async_vs_sync(cfg, AB_STEPS,
                                           num_workers=workers,
                                           device="cuda", keep_states=True)
            res.peak_gib = torch.cuda.max_memory_allocated() / 2**30
            _ab_log(f"{r50}, K = {workers}", res, batch, "images", card)
            for mode in ("sync", "async"):
                check_launches(f"A/B {r50} K = {workers}, {mode}",
                               res.launches[mode], k1_run)
            ab[workers] = res
        one, four = ab[1], ab[AB_WORKERS]
        a = state_tensors(one.sync_state)
        b = state_tensors(one.async_state)
        same = sum(bool(torch.equal(x, y)) for x, y in zip(a, b))
        log(f"A/B {r50}, K = 1: async against sync: losses "
            f"{'equal' if one.async_losses == one.sync_losses else 'differ'}"
            f", {same} of {len(a)} state tensors bit for bit; peak memory "
            f"{one.peak_gib:.2f} GiB (K = 1), {four.peak_gib:.2f} GiB "
            f"(K = {AB_WORKERS}: {AB_WORKERS} snapshots and a stash of the "
            f"f32 parameters more) | {card}")
        if one.async_losses != one.sync_losses or same != len(a) or len(
                a) != len(b):
            fail(f"A/B {r50}, K = 1: the async mode differs from the sync "
                 f"mode")
        del a, b, one.sync_state, one.async_state, four.sync_state
        want_log = [min(e, AB_WORKERS - 1) for e in range(AB_STEPS)]
        if four.staleness_log != want_log:
            fail(f"A/B {r50}, K = {AB_WORKERS}: staleness "
                 f"{four.staleness_log}, expected {want_log}")
        # The async events replayed against the emulator run eagerly.
        mesh, state = fresh(cfg)
        batches = ab_batches(cfg, AB_STEPS, mesh)
        with meshlib.data_parallel(mesh, trainlib.seq_dim(cfg)):
            eager = async_ps.AsyncPSEmulator(
                state, trainlib.build_loss(cfg, state),
                async_ps.AsyncConfig(num_workers=AB_WORKERS, seed=cfg.seed),
                name=cfg.model, capture=False)
            losses = [float(r["metrics"]["loss"])
                      for r in eager.run(batches, seed)]
        a = state_tensors(eager.state)
        b = state_tensors(four.async_state)
        same = sum(bool(torch.equal(x, y)) for x, y in zip(a, b))
        log(f"A/B {r50}, K = {AB_WORKERS}: the replayed async events against "
            f"the emulator run eagerly: losses "
            f"{'equal' if losses == four.async_losses else 'differ'}, "
            f"{same} of {len(a)} state tensors bit for bit | {card}")
        if losses != four.async_losses or same != len(a) or len(a) != len(b):
            fail(f"A/B {r50}: the replayed async events differ from the "
                 f"eager ones")
        del a, b, eager, state, four.async_state
        # The staleness limit.
        mesh, state = fresh(cfg)
        with meshlib.data_parallel(mesh, trainlib.seq_dim(cfg)):
            lim = async_ps.AsyncPSEmulator(
                state, trainlib.build_loss(cfg, state),
                async_ps.AsyncConfig(num_workers=AB_WORKERS, seed=cfg.seed,
                                     staleness_limit=AB_LIMIT),
                name=cfg.model)
            lim.warm_up(batches[0], seed)
            recs = lim.run(batches, seed)
        want_log, want_drops = _predicted_drops(AB_WORKERS, AB_LIMIT,
                                                AB_STEPS)
        drops = [r["dropped"] for r in recs]
        log(f"{r50}, K = {AB_WORKERS} at staleness limit {AB_LIMIT}: "
            f"staleness {lim.staleness_log}, dropped {drops} (predicted "
            f"{want_drops}), canonical step {lim.state.step} | {card}")
        if (lim.staleness_log, drops) != (want_log, want_drops) or (
                lim.state.step != AB_STEPS - sum(want_drops)):
            fail(f"{r50} at staleness limit {AB_LIMIT}: staleness "
                 f"{lim.staleness_log}, drops {drops}, step {lim.state.step}")
        del lim, state, recs
        out["r50"] = {"ab": {w: {"sync_s": r.sync_seconds,
                                 "async_s": r.async_seconds,
                                 "capture_s": r.capture_s,
                                 "peak_gib": r.peak_gib}
                             for w, r in ab.items()}}

        # (b) Backup replicas on the batch's shards.
        M, N = AB_BACKUP
        order = np.random.RandomState(cfg.seed).permutation(M)
        chosen, late = [int(i) for i in order[:N]], int(order[N])
        shards = backup.split_into_shards(batches[0], M)
        zeroed = list(shards)
        zeroed[late] = {k: torch.zeros_like(v) for k, v in shards[late].items()}
        rounds = []
        for label, sh in (("plain", shards), ("zeroed", zeroed)):
            mesh, state = fresh(cfg)
            with meshlib.data_parallel(mesh, trainlib.seq_dim(cfg)):
                emu = backup.SyncBackupEmulator(
                    state, trainlib.build_loss(cfg, state),
                    backup.BackupConfig(M, N, seed=cfg.seed), name=cfg.model)
                emu.warm_up(sh, seed)
                before = k1.launches
                rec = emu.step(sh, seed)
                per_round = k1.launches - before
            if rec["chosen"] != chosen:
                fail(f"backup: chosen {rec['chosen']}, predicted {chosen}")
            if per_round != N * k1_per_step:
                fail(f"backup: K1 {per_round} launches a round, expected "
                     f"{N * k1_per_step}")
            rounds.append((label, emu, per_round))
        a = state_tensors(rounds[0][1].state)
        b = state_tensors(rounds[1][1].state)
        same = sum(bool(torch.equal(x, y)) for x, y in zip(a, b))
        # One forward of the last chosen replica's shard from the canonical
        # statistics.
        mesh, ref = fresh(cfg)
        gens = train_loop.StepRngs(("dropout",), dev).reseed(0, 0)
        with torch.no_grad(), meshlib.data_parallel(mesh):
            ref.model(shards[chosen[-1]]["image"], train=True, rngs=gens)
        stats = [(x, y) for x, y in zip(
            rounds[0][1].state.batch_stats.values(),
            ref.batch_stats.values()) if x.is_floating_point()]
        stat_same = sum(bool(torch.equal(x, y)) for x, y in stats)
        stat_err = max(float(((x - y).abs() / (y.abs() + 1e-6)).max())
                       for x, y in stats)
        log(f"backup M = {M}, N = {N} on {batch // M}-row shards: chosen "
            f"{chosen}, discarded [{late}]; the discarded shard zeroed: "
            f"{same} of {len(a)} state tensors bit for bit; BN statistics "
            f"against one update by the last chosen replica: {stat_same} of "
            f"{len(stats)} bit for bit, largest relative difference "
            f"{stat_err:.3g}; K1 {[r[2] for r in rounds]} launches a round "
            f"(expected {N * k1_per_step}) | {card}")
        if same != len(a) or len(a) != len(b):
            fail("backup: the discarded replica's shard moved the state")
        if stat_err > 1e-6:
            fail(f"backup: BN statistics {stat_err:.3g} from one update by "
                 f"the last chosen replica")
        del a, b, rounds, ref, shards, zeroed
        cache.clear()

        # (c) transformer_lm on flash.
        lm_cfg = get_config(lm, attn_impl="flash")
        layers = lm_cfg.model_kwargs["num_layers"]
        tokens = lm_cfg.global_batch_size * lm_cfg.num_steps
        want = {flash_keys[kid]: layers * AB_STEPS for kid in ("K2", "K3",
                                                              "K4")}
        lm_ab = {}
        for workers in AB_LM_WORKERS:
            reset_peak()
            res = experiment.async_vs_sync(lm_cfg, AB_STEPS,
                                           num_workers=workers,
                                           device="cuda",
                                           keep_states=workers == 1)
            res.peak_gib = torch.cuda.max_memory_allocated() / 2**30
            _ab_log(f"{lm}, K = {workers}", res, tokens, "tokens", card)
            for mode in ("sync", "async"):
                check_launches(f"A/B {lm} K = {workers}, {mode}",
                               res.launches[mode], want)
            lm_ab[workers] = res
        one = lm_ab[1]
        _lm_states_close(f"A/B {lm}, K = 1: async against sync",
                         one.async_losses, one.sync_losses,
                         state_tensors(one.async_state),
                         state_tensors(one.sync_state), card)
        del one.sync_state, one.async_state
        out["lm"] = {w: {"sync_s": r.sync_seconds, "async_s": r.async_seconds,
                         "capture_s": r.capture_s, "peak_gib": r.peak_gib}
                     for w, r in lm_ab.items()}
        cache.clear()

        # (d) The CLI's ab in this process.
        rc, res = _cli_in_process([
            "ab", "--config", r50, "--steps", str(AB_CLI_STEPS),
            "--async-workers", str(AB_CLI_WORKERS), "--batch-size",
            str(batch), "--device", "cuda"])
        hist = dict(collections.Counter(
            str(min(e, AB_CLI_WORKERS - 1)) for e in range(AB_CLI_STEPS)))
        log(f"cli ab --config {r50} --steps {AB_CLI_STEPS} --async-workers "
            f"{AB_CLI_WORKERS}: {json.dumps(res)}")
        if (rc != 0 or set(res) != {"sync", "async"}
                or len(res["async"]["losses"]) != AB_CLI_STEPS
                or res["async"]["staleness_hist"] != hist):
            fail(f"cli ab: exit {rc}, {res}")
    finally:
        experiment.ab_batches = real_batches
    out["launches"] = {"K1": k1.launches, "K6": k6.launches,
                       **{kid: fn.launches for kid, fn in flash_fns.items()}}
    log(f"A/B phase launches: {out['launches']}")
    if (not k1.launches or k6.launches or any(
            not out["launches"][kid] for kid in ("K2", "K3", "K4"))):
        fail(f"A/B phase: launches {out['launches']}")
    log(f"A/B phase: {time.perf_counter() - t_phase:.1f} s")
    return out


# Phase 20: the serving engine on transformer_lm at full width.  R1's
# SIMT form (f32 operands, and N = 1) is held to its plain version bit for
# bit (the same f32 additions in the same order: exact, no tolerance); its
# tensor-core form (bf16 operands, N > 1) to the forward-error bound of an
# f32 sum of K exact products (_r1_excess), and each of its launches to
# itself with the rows one at a time and in halves, bit for bit.  R1's
# bound: bf16 operands at the dense bf16 peak, f32 operands at the f32
# peak outside the tensor cores (it computes in full f32).
R1_SOURCE = "distributed_tensorflow_models_tpu_torch/csrc/row_gemm.cu"
PEAK_F32_FLOPS = 67e12
SERVE_ENGINE = dict(max_slots=8, prefill_chunk=32, prefill_lanes=2,
                    kv_page_tokens=16)
SERVE_REQUESTS = 16
SERVE_SHARED_PREFIX = 128
SERVE_SHARERS = (2, 5, 9, 13)
# Arrival step of each request id (the rest arrive at step 0).
SERVE_ARRIVALS = {8: 6, 9: 6, 10: 12, 11: 12, 12: 20, 13: 20, 14: 30,
                  15: 30}
SERVE_MODES = ((0.0, 0, 1.0), (1.0, 0, 1.0), (0.8, 5, 1.0), (1.0, 0, 0.9),
               (0.7, 8, 0.85), (0.0, 0, 1.0))


def _serve_traffic(seed: int, vocab: int) -> list[dict]:
    """The phase's 16 requests: prompts of 17-200 tokens and 32-96 new
    tokens from ``seed``, the six sampling modes in turn, four prompts on
    one shared 128-token prefix (two in the first wave, cold; two later,
    warm, each with its own tail: copy-on-write past the shared pages)."""
    import numpy as np

    rs = np.random.RandomState(seed)
    shared = rs.randint(0, vocab, SERVE_SHARED_PREFIX)
    out = []
    for i in range(SERVE_REQUESTS):
        plen = int(rs.randint(17, 201))
        if i in SERVE_SHARERS:
            plen = max(plen, SERVE_SHARED_PREFIX + 12)
            prompt = np.concatenate([shared, rs.randint(
                0, vocab, plen - SERVE_SHARED_PREFIX)])
        else:
            prompt = rs.randint(0, vocab, plen)
        t, k, p = SERVE_MODES[i % len(SERVE_MODES)]
        out.append(dict(rid=i, prompt=prompt.astype(np.int32),
                        max_new=int(rs.randint(32, 97)), t=t, k=k, p=p,
                        seed=seed * 1000 + i if t > 0 else None))
    return out


def _solo_stream(model, r: dict) -> list:
    """Request ``r`` through solo ``generate`` at batch 1 (its step
    captured on the card)."""
    import torch

    from distributed_tensorflow_models_tpu_torch.harness import generate as genlib

    device = model.head.kernel.device
    out = genlib.generate(
        model, torch.tensor(r["prompt"][None], dtype=torch.int64,
                            device=device), r["max_new"], temperature=r["t"],
        top_k=r["k"], top_p=r["p"], seed=r["seed"])
    return out[0, len(r["prompt"]):].tolist()


class _CountedProgram:
    """An engine program that counts its dispatches."""

    def __init__(self, prog):
        self.prog, self.calls = prog, 0

    def __call__(self):
        self.calls += 1
        self.prog()

    @property
    def built(self) -> bool:
        return self.prog.built


def _serve(eng, traffic: list[dict], arrivals: dict) -> dict:
    """Drive ``traffic`` through a scheduler over ``eng``; request ``rid``
    arrives at step ``arrivals.get(rid, 0)``.  Returns ``{rid: tokens}``."""
    from distributed_tensorflow_models_tpu_torch.serving import scheduler

    sched = scheduler.ContinuousBatchingScheduler(eng)
    done, step = [], 0
    last = max(arrivals.values(), default=0)
    while step <= last or sched.has_work:
        for r in traffic:
            if arrivals.get(r["rid"], 0) == step:
                sched.submit(scheduler.Request(
                    r["rid"], r["prompt"], r["max_new"], temperature=r["t"],
                    top_k=r["k"], top_p=r["p"], rng=r["seed"]))
        done += sched.step()
        if eng.fsck():
            fail(f"serve: fsck after step {step}: {eng.fsck()}")
        step += 1
        if step > 2000:
            fail("serve: the scheduler did not drain in 2000 steps")
    return {c.request_id: c.tokens for c in done}


def _record_r1(fn):
    """The R1 products ``fn()`` runs, as ``(a, b, out_dtype)`` (clones of
    the operands in their strided layout), ``fn``'s result."""
    import torch

    from distributed_tensorflow_models_tpu_torch.ops import rowwise

    calls = []
    real = rowwise.row_matmul

    def record(a, b, out_dtype=None):
        def keep(t):
            return torch.empty_strided(t.shape, t.stride(), dtype=t.dtype,
                                       device=t.device).copy_(t)
        calls.append((keep(a), keep(b), out_dtype or a.dtype))
        return real(a, b, out_dtype)

    # The real wrapper counts its launches on the module's row_matmul:
    # these checking launches land on the recorder's own counters, not on
    # the main path's.
    record.launches = record.wgmma_launches = record.simt_launches = 0
    rowwise.row_matmul = record
    try:
        with torch.no_grad():
            out = fn()
    finally:
        rowwise.row_matmul = real
    return calls, out


def _r1_excess(got, plain, a4, b4) -> tuple[float, float]:
    """The tensor-core form against the plain version on the same
    operands: ``(max |got - plain| - limit, max |got - plain| / limit)``,
    the limit ``K 2^-22 sum_k |a_k b_k|`` (f64, from the operands: both
    are f32 sums of K exact bf16 products, this is their forward-error
    bound with room for the rounding inside a k16 step), and one bf16
    ulp more (at the larger of the two) for a bf16 result, each side that
    f32 sum rounded once."""
    import torch

    diff = (got.double() - plain.double()).abs()
    lim = a4.shape[-1] * 2.0 ** -22 * torch.matmul(
        a4.double().abs(), b4.double().abs()).reshape(got.shape)
    if got.dtype == torch.bfloat16:
        _, e = torch.frexp(torch.maximum(got.double().abs(),
                                         plain.double().abs()))
        lim = lim + torch.ldexp(torch.ones_like(diff), e - 8)
    return (float((diff - lim).max()),
            float((diff / lim.clamp_min(1e-300)).max()))


def _r1_table(calls, label: str, card: str) -> dict:
    """Each recorded product in the form ``rowwise._plan`` picks: the
    tensor-core form (bf16, N > 1) within ``_r1_excess``'s bound of its
    plain version on its own operands, and equal bit for bit to itself
    re-run with its rows one at a time and in two halves; the SIMT form
    (f32, N = 1) equal to its plain version bit for bit.  Then per
    distinct shape R1 and ``torch.matmul`` (the library call on the same
    operands, in their dtype) timed by CUDA-graph replay (``graph_ms``:
    at these sizes events over eager calls time the host), the plain
    version by events, and the bound from the bytes (each input once,
    the output once; a weight broadcast over groups once) and the
    operations.  Sums over the calls."""
    import torch

    from distributed_tensorflow_models_tpu_torch.ops import rowwise

    tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0,
               flops=0.0, bytes=0.0, t_ops=0.0, t_bytes=0.0)
    forms = {"wgmma": 0, "simt": 0}
    groups: dict = {}
    err = share = 0.0
    for a, b, out_dtype in calls:
        a4, b4, _ = rowwise._operands(a, b)
        got = rowwise.row_matmul(a, b, out_dtype)
        want = rowwise._plain_matmul(a4, b4, out_dtype).reshape(got.shape)
        d = float((got.float() - want.float()).abs().max())
        G1, G2, M, K = a4.shape
        form = rowwise._plan(a.dtype, out_dtype, b4.shape[3], K).form
        forms[form] += 1
        where = f"{tuple(a4.shape)} x {tuple(b4.shape)}"
        if form == "simt" and not torch.equal(got, want):
            fail(f"{label}: R1's SIMT form differs from its plain version "
                 f"at {where} (max abs {d})")
        if form == "wgmma":
            over, frac = _r1_excess(got, want, a4, b4)
            if over > 0:
                fail(f"{label}: R1's tensor-core form is past its bound of "
                     f"the plain version at {where} (by {over})")
            share = max(share, frac)
            got4 = got.reshape(G1, G2, M, -1)
            rows = torch.cat([rowwise.row_matmul(a4[:, :, i:i + 1], b4,
                                                 out_dtype)
                              for i in range(M)], 2)
            h = max(1, M // 2)
            halves = torch.cat([rowwise.row_matmul(a4[:, :, :h], b4,
                                                   out_dtype),
                                rowwise.row_matmul(a4[:, :, h:], b4,
                                                   out_dtype)], 2)
            if not (torch.equal(rows, got4) and torch.equal(halves, got4)):
                fail(f"{label}: R1's tensor-core form gives other bits at "
                     f"{where} with its rows one at a time or in two halves")
        err = max(err, d)
        key = (tuple(a4.shape), a4.stride(), tuple(b4.shape), b4.stride(),
               a.dtype, out_dtype)
        groups.setdefault(key, [a, b, out_dtype, 0])[3] += 1
    for (ashape, _, bshape, bstride, dt, odt), (a, b, out_dtype, n) in (
            groups.items()):
        a4, b4, _ = rowwise._operands(a, b)
        G1, G2, M, K = ashape
        N = bshape[3]
        esz = a.element_size()
        b_unique = (bshape[0] * bshape[1] if bstride[0] or bstride[1]
                    else 1) * K * N
        out_esz = torch.empty((), dtype=odt).element_size()
        nbytes = esz * (a.numel() + b_unique) + G1 * G2 * M * N * out_esz
        flops = 2.0 * G1 * G2 * M * N * K
        peak = PEAK_BF16_FLOPS if dt == torch.bfloat16 else PEAK_F32_FLOPS
        t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES_PER_S
        r1_ms = graph_ms(lambda: rowwise.row_matmul(a, b, out_dtype))
        lib_ms = graph_ms(lambda: torch.matmul(a4, b4))
        plain_ms = time_ms(lambda: rowwise._plain_matmul(a4, b4, out_dtype),
                           1, warmup=1)
        tot["ms"] += n * r1_ms
        tot["library_ms"] += n * lib_ms
        tot["plain_ms"] += n * plain_ms
        tot["bound_ms"] += n * 1e3 * max(t_ops, t_bytes)
        tot["t_ops"] += n * t_ops
        tot["t_bytes"] += n * t_bytes
        tot["flops"] += n * flops
        tot["bytes"] += n * nbytes
        log(f"  {n} x a{list(ashape)} @ b{list(bshape)} {str(dt)[6:]}->"
            f"{str(odt)[6:]}: R1 {r1_ms:.4f} ms, torch.matmul {lib_ms:.4f}, "
            f"plain {plain_ms:.3f}, bound {1e3 * max(t_ops, t_bytes):.5f}")
    tot["bound_by"] = ("operations" if tot["t_ops"] >= tot["t_bytes"]
                       else "bytes")
    log(f"{label}: {len(calls)} R1 launches: {forms['wgmma']} tensor-core "
        f"(each within its bound of the plain version, at most "
        f"{share:.4f} of it, and equal to its rows one at a time and in "
        f"halves), {forms['simt']} SIMT (each equal to its plain version "
        f"bit for bit); max abs {err:.3g}; R1 {tot['ms']:.3f} ms, plain "
        f"{tot['plain_ms']:.3f} ms, torch.matmul {tot['library_ms']:.3f} "
        f"ms, bound {tot['bound_ms']:.4f} ms ({tot['bound_by']}: "
        f"{tot['flops'] / 1e9:.3f} GFLOP, {tot['bytes'] / 1e6:.2f} MB) | "
        f"{card}")
    return {**tot, "launches": len(calls), "max_abs_err": err,
            "forms": forms, "bound_share": share}


def _invariance_check(model, seed: int, card: str) -> dict:
    """One prompt's K/V and logits whole and in chunks of 1 and 32, and
    an ``[8, 1]`` step over per-lane lengths against each lane's
    ``[1, 1]`` step alone, all bit for bit; the R1 launches of that step
    and of a ``[2, 32]`` prefill chunk, recorded for timing."""
    import numpy as np
    import torch

    from distributed_tensorflow_models_tpu_torch.models.transformer_lm import (
        KVCache,
    )

    rs = np.random.RandomState(seed)
    V = model.head.kernel.shape[1]
    dev = model.head.kernel.device
    prompt = torch.tensor(rs.randint(0, V, (1, 150)), device=dev)

    def prefill(chunk):
        cache = model.init_cache(1, dev)
        with torch.no_grad():
            logits = torch.cat([model(prompt[:, i:i + chunk], cache=cache)[0]
                                for i in range(0, 150, chunk)], 1)
        return logits, cache

    whole, cw = prefill(150)
    for chunk in (32, 1):
        got, cc = prefill(chunk)
        if not torch.equal(got, whole):
            fail(f"invariance: logits of chunks of {chunk} differ from the "
                 f"whole prompt's ({int((got != whole).sum())} values)")
        for i, (a, b) in enumerate(zip(cc.keys + cc.values,
                                       cw.keys + cw.values)):
            if not torch.equal(a, b):
                fail(f"invariance: chunks of {chunk} wrote other K/V bits "
                     f"(cache tensor {i}: {int((a != b).sum())} values)")
    lengths = [150, 20, 77, 0, 160, 33, 101, 64]
    prompts = [torch.tensor(rs.randint(0, V, (1, n)), device=dev)
               for n in lengths]
    prompts[0] = prompt
    nxt = torch.tensor(rs.randint(0, V, (8, 1)), device=dev)
    solo, caches = [], []
    with torch.no_grad():
        for p, n, t in zip(prompts, lengths, nxt):
            cache = model.init_cache(1, dev)
            if n:
                model(p, cache=cache)
            caches.append([x.clone() for x in cache.keys + cache.values])
            solo.append((model(t[None], cache=cache)[0], cache))
    L = model.num_layers
    lanes = KVCache([torch.cat([c[i] for c in caches]) for i in range(L)],
                    [torch.cat([c[L + i] for c in caches])
                     for i in range(L)],
                    torch.tensor(lengths, device=dev))
    step_calls, step = _record_r1(lambda: model(nxt, cache=lanes)[0])
    for s in range(8):
        if not torch.equal(step[s:s + 1], solo[s][0]):
            fail(f"invariance: lane {s} of the [8, 1] step differs from its "
                 f"[1, 1] step alone")
        for i in range(L):
            if not (torch.equal(lanes.keys[i][s:s + 1], solo[s][1].keys[i])
                    and torch.equal(lanes.values[i][s:s + 1],
                                    solo[s][1].values[i])):
                fail(f"invariance: lane {s}'s K/V of block {i} differ from "
                     f"its step alone")
    chunk = KVCache([c.repeat(2, 1, 1, 1) for c in cw.keys],
                    [c.repeat(2, 1, 1, 1) for c in cw.values],
                    torch.tensor([0, 64], device=dev))
    prefill_calls, _ = _record_r1(
        lambda: model(prompt[:, :64].reshape(2, 32), cache=chunk))
    log(f"invariance: a 150-token prompt whole = chunks of 32 = chunks of 1 "
        f"(logits and every block's K/V bit for bit); an [8, 1] step at "
        f"lane lengths {lengths} = each lane's [1, 1] step alone (logits "
        f"and K/V) | {card}")
    return {"step_calls": step_calls, "prefill_calls": prefill_calls}


def phase_serve(card: str, seed: int, model=None) -> dict:
    """Phase 20, the serving engine (``serving/``) on ``transformer_lm`` at
    full width (its seeded init; ``model``, another ``TransformerLM`` on
    its device, to rehearse the phase): the invariance check, R1 at the
    main path's shapes, the engine's traffic against solo ``generate``,
    the burst and speculation arms."""
    import numpy as np
    import torch

    from distributed_tensorflow_models_tpu_torch.harness import train as trainlib
    from distributed_tensorflow_models_tpu_torch.harness.config import get_config
    from distributed_tensorflow_models_tpu_torch.ops import rowwise
    from distributed_tensorflow_models_tpu_torch.serving import engine as englib
    from distributed_tensorflow_models_tpu_torch.telemetry import registry

    t_phase = time.perf_counter()
    if model is None:
        model = trainlib.build_model(get_config("transformer_lm"),
                                     torch.device("cuda"))
    model.eval()
    device = model.head.kernel.device
    V = model.head.kernel.shape[1]
    inv = _invariance_check(model, seed, card)
    r1_step = _r1_table(inv["step_calls"], "R1, one [8, 1] decode step",
                        card)
    r1_prefill = _r1_table(inv["prefill_calls"],
                           "R1, one [2, 32] prefill dispatch", card)
    # (c) The traffic, served, after one warm-up request that builds
    # (captures) both programs; R1's counter zeroed just before.
    traffic = _serve_traffic(seed, V)
    reg = registry.MetricsRegistry()
    eng = englib.InferenceEngine(model, device=device, registry=reg,
                                 **SERVE_ENGINE)
    _serve(eng, [dict(traffic[1], rid=99)], {})
    if eng.compile_counts() != (1, 1):
        fail(f"serve: the warm-up built {eng.compile_counts()} programs")
    eng._prefill_prog = _CountedProgram(eng._prefill_prog)
    reg0 = reg.snapshot()
    zero_counts([rowwise.row_matmul])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    served = _serve(eng, traffic, SERVE_ARRIVALS)
    torch.cuda.synchronize()
    served_s = time.perf_counter() - t0
    r1_launches = rowwise.row_matmul.launches
    r1_forms = {form: getattr(rowwise.row_matmul, f"{form}_launches")
                for form in ("wgmma", "simt")}
    # Every dispatch runs the step's products and sums in one proportion.
    step_forms = r1_step["forms"]
    if not r1_forms["wgmma"] or (r1_forms["wgmma"] * step_forms["simt"]
                                 != r1_forms["simt"] * step_forms["wgmma"]):
        fail(f"serve: the engine's run launched R1 {r1_forms} by form, not "
             f"in the step's proportion {step_forms}")
    snap = reg.snapshot()
    t0 = time.perf_counter()
    solo = {r["rid"]: _solo_stream(model, r) for r in traffic}
    torch.cuda.synchronize()
    solo_s = time.perf_counter() - t0
    for r in traffic:
        if served[r["rid"]] != solo[r["rid"]]:
            got, want = served[r["rid"]], solo[r["rid"]]
            at = next((i for i, (a, b) in enumerate(zip(got, want))
                       if a != b), min(len(got), len(want)))
            fail(f"serve: request {r['rid']} (mode {(r['t'], r['k'], r['p'])}"
                 f", prompt {len(r['prompt'])}) differs from solo generate "
                 f"from token {at} of {len(want)}")
    if eng.compile_counts() != (1, 1):
        fail(f"serve: {eng.compile_counts()} programs, expected (1, 1)")
    hits = snap.get("serve/prefix_cache_hits", 0.0) - reg0.get(
        "serve/prefix_cache_hits", 0.0)
    if not hits:
        fail("serve: the shared prefix was never reused")
    tokens = sum(r["max_new"] for r in traffic)
    n_dec = snap["serve/decode/count"] - reg0["serve/decode/count"]
    dec_ms = 1e3 * (snap["serve/decode/total_s"]
                    - reg0["serve/decode/total_s"]) / n_dec
    pre_ms = 1e3 * (snap["serve/prefill/total_s"]
                    - reg0["serve/prefill/total_s"]) / eng._prefill_prog.calls
    log(f"serve: {SERVE_REQUESTS} requests ({tokens} new tokens, prompts "
        f"{min(len(r['prompt']) for r in traffic)}-"
        f"{max(len(r['prompt']) for r in traffic)}, the six modes, four on "
        f"a {SERVE_SHARED_PREFIX}-token prefix: {int(hits)} blocks reused) "
        f"through {SERVE_ENGINE}: every stream = solo generate (captured, "
        f"batch 1) token for token; programs {eng.compile_counts()}; fsck "
        f"clean after every step; R1 {r1_launches} launches "
        f"({r1_forms['wgmma']} tensor-core, {r1_forms['simt']} SIMT) | "
        f"{card}")
    log(f"serve: {tokens / served_s:.1f} tokens/s served ({served_s:.3f} s) "
        f"against {tokens / solo_s:.1f} tokens/s through solo generate one "
        f"request at a time ({solo_s:.3f} s, each call capturing its step); "
        f"{eng._prefill_prog.calls} prefill dispatches at {pre_ms:.3f} ms, "
        f"{int(n_dec)} decode dispatches at {dec_ms:.3f} ms (host staging, the replay "
        f"and the read-back) | {card}")
    # (d) decode_burst 4 on four of the requests; spec_tokens 4 on a
    # random prompt, then a repetitive one, so that both decode programs
    # run and drafts are accepted.
    beng = englib.InferenceEngine(model, device=device,
                                  registry=registry.MetricsRegistry(),
                                  decode_burst=4, **SERVE_ENGINE)
    arm = traffic[:4]
    got = _serve(beng, arm, {3: 2})
    if any(got[r["rid"]] != solo[r["rid"]] for r in arm) or \
            beng.compile_counts() != (1, 1):
        fail(f"serve: the decode_burst 4 arm differs from solo generate or "
             f"built {beng.compile_counts()} programs")
    rs = np.random.RandomState(seed + 1)
    phrase = rs.randint(0, V, 6)
    spec_traffic = [
        dict(rid=0, prompt=rs.randint(0, V, 40).astype(np.int32),
             max_new=48, t=0.0, k=0, p=1.0, seed=None),
        dict(rid=1, prompt=np.tile(phrase, 10).astype(np.int32), max_new=64,
             t=0.0, k=0, p=1.0, seed=None),
        dict(rid=2, prompt=np.tile(phrase, 8).astype(np.int32), max_new=64,
             t=0.7, k=8, p=0.85, seed=seed * 1000 + 77)]
    sreg = registry.MetricsRegistry()
    seng = englib.InferenceEngine(model, device=device, registry=sreg,
                                  spec_tokens=4, **SERVE_ENGINE)
    got = _serve(seng, spec_traffic, {1: 2, 2: 2})
    for r in spec_traffic:
        if got[r["rid"]] != _solo_stream(model, r):
            fail(f"serve: spec_tokens 4, request {r['rid']} differs from "
                 f"solo generate")
    if seng.compile_counts() != (1, 2):
        fail(f"serve: the speculation arm built {seng.compile_counts()} "
             f"programs, expected (1, 2)")
    ss = sreg.snapshot()
    log(f"serve: decode_burst 4 on 4 requests = solo, programs (1, 1); "
        f"spec_tokens 4 (random prompt, then two on a repeated 6-token "
        f"phrase) = solo, programs (1, 2), {int(ss['serve/spec_accepted'])} "
        f"of {int(ss['serve/spec_drafted'])} drafts accepted, "
        f"{ss['serve/spec_tokens_per_dispatch/mean_s']:.2f} tokens a lane a "
        f"verify | {card}")
    log(f"serve phase: {time.perf_counter() - t_phase:.1f} s")
    return {"r1_launches": r1_launches, "r1_forms": r1_forms,
            "r1_step": r1_step, "r1_prefill": r1_prefill,
            "served_tokens_per_s": tokens / served_s,
            "solo_tokens_per_s": tokens / solo_s,
            "prefill_ms": pre_ms, "decode_ms": dec_ms}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batch-size", type=int, default=256,
                        help="global batch of the ResNet-50 and Inception-v3 "
                        "phases (their configs' own: 256)")
    parser.add_argument("--train-steps", type=int, default=11)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--parent-csrc", type=Path, default=None,
                        help="a csrc/ directory of another tree (say the "
                        "parent commit's, unpacked by git archive): after "
                        "phase 1 its bf16 K1 runs in turns with this "
                        "tree's at ResNet-50's launch shapes (outputs equal "
                        "bit for bit), and phase 8 also runs its flash "
                        "kernels, K5 dQ's differences from its K4 and its "
                        "K2-K5 replayed in turns with this tree's")
    parser.add_argument("--parent-tree", type=Path, default=None,
                        help="another checkout of the repository (say the "
                        "parent commit's, unpacked by git archive): phase 3b "
                        "also trains every zoo path through its fit and "
                        "this tree's (chunks of STEPS_PER_LOOP, captured) "
                        "in turns, each in a process of its own")
    parser.add_argument("--ab-only", action="store_true",
                        help="with --parent-tree: phase 1 and the two "
                        "trees' fit in turns alone; no result line")
    parser.add_argument("--flash-only", action="store_true",
                        help="phases 1 and 8 alone, for work on K2-K5: no "
                        "main path and no result line")
    parser.add_argument("--dp-only", action="store_true",
                        help="phases 1 and 5b alone, for work on data "
                        "parallelism: no result line")
    parser.add_argument("--resume-only", action="store_true",
                        help="phases 1 and 5c alone, for work on "
                        "checkpoint/resume: no result line")
    parser.add_argument("--telemetry-only", action="store_true",
                        help="phases 1 and 5d alone, for work on telemetry "
                        "and eval: no result line")
    parser.add_argument("--chaos-only", action="store_true",
                        help="phases 1 and 5e alone, for work on fault "
                        "injection and the launcher: no result line")
    parser.add_argument("--zoo-only", action="store_true",
                        help="phases 1 and 11-13 alone, for work on the "
                        "LeNet, ResNet-32, VGG-16, AlexNet and PTB LSTM "
                        "paths: no result line")
    parser.add_argument("--generate-only", action="store_true",
                        help="phases 1 and 14 alone, for work on the "
                        "KV-cache decode: no result line")
    parser.add_argument("--model-knobs-only", action="store_true",
                        help="phases 1 and 16 alone, for work on the MoE "
                        "transformer, remat, the embedding's matmul "
                        "gradient and blockwise q-chunking: no result line")
    parser.add_argument("--parallel-only", action="store_true",
                        help="phases 1, 17 and 18 alone, for work on "
                        "tensor, sequence, pipeline and expert "
                        "parallelism: no result line")
    parser.add_argument("--async-only", action="store_true",
                        help="phases 1 and 19 alone, for work on the "
                        "async-PS vs sync A/B and its emulators: no result "
                        "line")
    parser.add_argument("--serve-only", action="store_true",
                        help="phases 1 and 20 alone, for work on the "
                        "serving engine and R1: no result line")
    parser.add_argument("--startup-only", action="store_true",
                        help="phase 1, the checkpoint's training of phase "
                        "14 and phase 15 alone, for work on the cold "
                        "start: no result line")
    args = parser.parse_args(argv)

    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke test runs on the card only")
    # conv.py reads the default conv lowering when it is first imported.
    os.environ["DTM_CONV_IMPL"] = "mxu"
    os.environ["DTM_CONV_MXU_PIPELINE"] = "0"
    os.environ["DTM_FLASH_BWD"] = "pair"
    sys.path.insert(0, str(ROOT))
    from distributed_tensorflow_models_tpu_torch.harness.config import get_config
    from distributed_tensorflow_models_tpu_torch.ops import _kernels
    from distributed_tensorflow_models_tpu_torch.ops import attention as attnlib
    from distributed_tensorflow_models_tpu_torch.ops import conv as convlib
    from distributed_tensorflow_models_tpu_torch.ops import conv_mxu
    from distributed_tensorflow_models_tpu_torch.ops import rowwise

    # f32 comparisons in full f32: no TF32 in cuDNN or cuBLAS.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    steps = args.train_steps
    k1, k6 = conv_mxu.conv_implicit_gemm, conv_mxu.conv_implicit_gemm_pipelined
    flash_fns = {kid: getattr(attnlib, name)
                 for kid, name, _ in FLASH_KERNELS + STAGED_KERNELS}

    # 1. Device and build.
    card = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    log(f"card: {card} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {kind}")
    t0 = time.perf_counter()
    parent = parent_conv = None
    builds = [("K1, K6", "conv_implicit_gemm.cu"),
              ("K2-K5", "flash_attention.cu"), ("R1", "row_gemm.cu")]
    with concurrent.futures.ThreadPoolExecutor(5) as pool:
        futs = [pool.submit(conv_mxu._load), pool.submit(attnlib._load),
                pool.submit(rowwise._load)]
        if args.parent_csrc is not None:
            csrc = args.parent_csrc.resolve()
            futs += [pool.submit(_kernels.load, name, csrc) for name in
                     ("conv_implicit_gemm.cu", "flash_attention.cu")]
            builds += [("the parent tree's K1, K6",
                        str(csrc / "conv_implicit_gemm.cu")),
                       ("the parent tree's K2-K5",
                        str(csrc / "flash_attention.cu"))]
        for fut in futs:
            fut.result()
        if args.parent_csrc is not None:
            parent = attnlib.typed(futs[-1].result())
            parent_conv = futs[-2].result()
    for kids, src in builds:
        nvcc_s = _kernels.build_seconds.get(src)
        log(f"{kids} ({src}) build+load: " + (
            "cached build loaded" if nvcc_s is None
            else f"nvcc {nvcc_s:.2f} s"))
        for line in ptxas_summary(_kernels.build_logs.get(src, "")):
            log(f"  ptxas {line}")
    k2_lines = [line for line in ptxas_summary(
        _kernels.build_logs.get("flash_attention.cu", ""))
        if "dtm_flash_fwd_kernel" in line]
    log(f"K2 instances (D 32, 64, 128): {len(k2_lines)} in this build" + (
        "" if k2_lines else " (a cached build: no ptxas output)"))
    for line in k2_lines:
        log(f"  K2 ptxas {line}")
    bwd_lines = [line for line in ptxas_summary(
        _kernels.build_logs.get("flash_attention.cu", ""))
        if "dtm_flash_dkv_kernel" in line
        or "dtm_flash_dq_staged_kernel" in line]
    log(f"K3 and K5 instances (dKV without and with the dS stage, staged "
        f"dQ; D 32, 64, 128): {len(bwd_lines)} in this build")
    for line in bwd_lines:
        log(f"  K3/K5 ptxas {line}")
    k4_lines = [line for line in ptxas_summary(
        _kernels.build_logs.get("flash_attention.cu", ""))
        if "dtm_flash_dq_kernel" in line]
    log(f"K4 instances (D 32, 64, 128): {len(k4_lines)} in this build")
    for line in k4_lines:
        log(f"  K4 ptxas {line}")
    log(f"the builds, in parallel: {time.perf_counter() - t0:.2f} s wall")
    hgmma = r1_sass_hgmma()
    if len(hgmma) != 4 or not all(hgmma.values()):
        fail(f"R1's tensor-core kernels (two result dtypes x b K- or "
             f"N-major) hold HGMMA {hgmma} in the built library's SASS")
    log(f"R1's tensor-core kernels in SASS: {sorted(hgmma.values())} HGMMA "
        f"each in {len(hgmma)} instances")

    if parent_conv is not None:
        # Another tree's bf16 K1 at ResNet-50's launch shapes, in turns.
        phase_conv_ab(core_launch_shapes("resnet50", 224, args.batch_size),
                      parent_conv, args.seed, card)
    if args.flash_only:
        phase_flash(args.seed + 2, parent)
        log(card)
        log("flash-only run: phases 1 and 8 alone, no main path, no result")
        return 0
    workdir = ROOT / "build" / "chip_smoke"
    # Every fit with a workdir resumes from its checkpoints: start empty,
    # so that no run resumes one of an earlier smoke run.
    shutil.rmtree(workdir, ignore_errors=True)
    if args.resume_only:
        phase_resume(args.batch_size, card, workdir / "resume")
        log(card)
        log("resume run: phases 1 and 5c alone, no result")
        return 0
    if args.telemetry_only:
        phase_telemetry_eval(args.batch_size, card, workdir / "telemetry",
                             25, args.seed)
        log(card)
        log("telemetry run: phases 1 and 5d alone, no result")
        return 0
    if args.chaos_only:
        k1_per_step = len(core_launch_shapes("resnet50", 224,
                                             args.batch_size))
        phase_chaos(args.batch_size, card, workdir / "chaos", k1,
                    k1_per_step)
        log(card)
        log("chaos run: phases 1 and 5e alone, no result")
        return 0
    if args.zoo_only:
        phases_zoo(args.train_steps, args.seed + 4, card, workdir)
        log(card)
        log("zoo-only run: phases 1 and 11-13 alone, no result")
        return 0
    if args.generate_only:
        phase_generate(card, workdir / "generate", flash_fns)
        log(card)
        log("generate-only run: phases 1 and 14 alone, no result")
        return 0
    if args.startup_only:
        train_lm_checkpoint(workdir / "generate" / "lm", flash_fns,
                            GEN_TRAIN_STEPS)
        phase_startup(card, workdir / "startup", workdir / "generate" / "lm")
        log(card)
        log("startup-only run: phase 1, phase 14's checkpoint and phase 15 "
            "alone, no result")
        return 0
    if args.model_knobs_only:
        phase_model_knobs(card, workdir / "knobs", flash_fns, k1, k6,
                          args.batch_size, args.seed + 5)
        log(card)
        log("model-knobs run: phases 1 and 16 alone, no result")
        return 0
    if args.parallel_only:
        phase_parallel(card, workdir / "parallel", flash_fns, k1,
                       args.batch_size, args.seed + 6)
        phase_pipe_expert(card, workdir / "pipe_expert", flash_fns,
                          args.seed + 7)
        log(card)
        log("parallel run: phases 1, 17 and 18 alone, no result")
        return 0
    if args.serve_only:
        phase_serve(card, args.seed + 8)
        log(card)
        log("serve run: phases 1 and 20 alone, no result")
        return 0
    if args.async_only:
        phase_async(card, flash_fns, k1, k6, len(core_launch_shapes(
            "resnet50", 224, args.batch_size)), args.batch_size)
        log(card)
        log("async run: phases 1 and 19 alone, no result")
        return 0
    if args.dp_only:
        phase_data_parallel(args.batch_size, args.train_steps, len(
            core_launch_shapes("resnet50", 224, args.batch_size)), card,
            workdir / "dp")
        log(card)
        log("data-parallel run: phases 1 and 5b alone, no result")
        return 0
    if args.ab_only:
        if args.parent_tree is None:
            fail("--ab-only needs --parent-tree")
        phase_tree_ab(args.parent_tree.resolve(), args.batch_size, card)
        log(card)
        log("trees-in-turns run: phases 1 and 3b's fit in turns alone, no "
            "result")
        return 0

    # 2. K1 at the ResNet-50 path's launch shapes.
    calls = core_launch_shapes("resnet50", 224, args.batch_size)
    roles = collections.Counter(r for r, _, _ in calls)
    log(f"K1 launches per ResNet-50 step at batch {args.batch_size}: "
        f"{len(calls)} ({dict(roles)})")
    if roles != {"fwd": 25, "dx": 25}:
        fail(f"expected 25 forward and 25 dx launches per step, got {roles}")
    k1_res = phase_k1(calls, args.seed)

    # 3. Gradients through conv2d_mxu.
    phase_grads(args.seed + 1)

    # 3b. The input pipeline alone; with --parent-tree, fit of both trees
    # in turns.
    phase_pipeline(card, args.batch_size, args.seed)
    if args.parent_tree is not None:
        phase_tree_ab(args.parent_tree.resolve(), args.batch_size, card)

    # 3c. Replay against eager on every zoo path.
    phase_replay(args.batch_size, card)
    log(f"elapsed {time.perf_counter() - t_start:.1f} s after phase 3c")

    # 4. The ResNet-50 path, K1's counter zeroed just before it.
    if convlib.get_default_conv_impl() != "mxu":
        fail("DTM_CONV_IMPL=mxu did not reach the port's conv selector")
    zero_counts((k1, k6))
    run = run_named("resnet50_synthetic", steps, args.batch_size,
                    workdir / "mxu")
    k1_launches, k6_stray = k1.launches, k6.launches
    want = len(calls) * steps
    log(f"K1 launches in the ResNet-50 run: {k1_launches} (expected "
        f"{len(calls)} per step x {steps} steps = {want}); K6 {k6_stray}")
    if k1_launches != want or k6_stray:
        fail(f"K1 launched {k1_launches} times (expected {want}), K6 "
             f"{k6_stray} (expected 0)")
    log(f"ResNet-50 path (K1 convs): batch {args.batch_size}, steps {steps}, "
        f"losses {run['losses']}, {run['images_per_sec']:.1f} images/s end "
        f"to end over {run['window_steps']} replayed steps; peak memory "
        f"{run['peak_gib']:.2f} GiB, K1 {k1_res['ms']:.2f} ms of the step "
        f"| {card}")
    # Yardstick: the same run with every conv through F.conv2d (cuDNN),
    # once, after the K1 arm.
    convlib.set_default_conv_impl("xla")
    arms = [("K1", run),
            ("F.conv2d", run_named("resnet50_synthetic", steps,
                                   args.batch_size, workdir / "xla1"))]
    for label, r in arms:
        log_arm(f"ResNet {label}", r, args.batch_size, card)
    # The CLI on the same path: three steps, K1 50 a step.
    convlib.set_default_conv_impl("mxu")
    zero_counts((k1, k6))
    cli_run = run_cli_train("resnet50_synthetic", 3, args.batch_size,
                            workdir / "cli")
    if (k1.launches, k6.launches) != (len(calls) * 3, 0):
        fail(f"the CLI's ResNet-50 run launched K1 {k1.launches} and K6 "
             f"{k6.launches} times, expected {len(calls) * 3} and 0")
    log(f"CLI train --config resnet50_synthetic --train-steps 3 "
        f"--steps-per-loop {STEPS_PER_LOOP}: {cli_run}")

    # 5. Where the ResNet step's device time goes, on both arms.
    r50 = get_config("resnet50_synthetic", global_batch_size=args.batch_size)
    for impl, arm in (("mxu", "ResNet-50, K1 convs"),
                      ("xla", "ResNet-50, F.conv2d convs")):
        convlib.set_default_conv_impl(impl)
        phase_profile(r50, arm)
    convlib.set_default_conv_impl("mxu")

    # 5b. The ResNet-50 path as one process of a world-1 NCCL group, after
    # fit without a group.
    phase_data_parallel(args.batch_size, steps, len(calls), card,
                        workdir / "dp")

    # 5c. Checkpoint/resume on the ResNet-50 path.
    phase_resume(args.batch_size, card, workdir / "resume")

    # 5d. A run's telemetry and its evaluation: ResNet-50 (K1) and
    # transformer_lm (K2).
    tel = phase_telemetry_eval(args.batch_size, card, workdir / "telemetry",
                               roles["fwd"], args.seed)
    log(f"elapsed {time.perf_counter() - t_start:.1f} s after phase 5d")

    # 5e. Fault injection and the localhost fleet on the ResNet-50 path,
    # K1's counter zeroed just before it and read just after.
    zero_counts((k1, k6))
    chaos = phase_chaos(args.batch_size, card, workdir / "chaos", k1,
                        len(calls))
    if chaos["k1_launches"] != k1.launches or k6.launches:
        fail(f"chaos phase: K1 counter {k1.launches} (the drills counted "
             f"{chaos['k1_launches']}), K6 {k6.launches}")

    log(f"elapsed {time.perf_counter() - t_start:.1f} s after phase 5e")

    # 6. K1 and K6 at every launch shape of the Inception-v3 path.
    inc_calls = core_launch_shapes("inception_v3", 299, args.batch_size,
                                   dropout_rate=0.0)
    inc_roles = collections.Counter(r for r, _, _ in inc_calls)
    log(f"conv core launches per Inception-v3 step at batch "
        f"{args.batch_size}: {len(inc_calls)} ({dict(inc_roles)}), "
        f"{len({(x, w) for _, x, w in inc_calls})} distinct shapes")
    k6_res = phase_k1(inc_calls, args.seed + 3)

    # 7. The Inception-v3 path with every routed conv on K6, the two
    # counters zeroed just before it and read just after; then the K1 arm
    # and the F.conv2d arm as a yardstick.
    inc_cfg = get_config("inception_v3_imagenet",
                         global_batch_size=args.batch_size)
    inc_arms = []
    for impl, knob, label in (("mxu", "1", "K6"), ("mxu", "0", "K1"),
                              ("xla", "0", "F.conv2d")):
        convlib.set_default_conv_impl(impl)
        os.environ["DTM_CONV_MXU_PIPELINE"] = knob
        zero_counts((k1, k6))
        r = run_named("inception_v3_imagenet", steps, args.batch_size,
                      workdir / f"inception{len(inc_arms)}")
        want = (len(inc_calls) * steps if impl == "mxu" else 0)
        got = (k6.launches, k1.launches) if knob == "1" else (k1.launches,
                                                              k6.launches)
        log(f"Inception-v3 arm {label}: {label if impl == 'mxu' else 'K1/K6'}"
            f" launches {got[0]} (expected {len(inc_calls)} per step x "
            f"{steps} steps = {want}), the other kernel {got[1]} (expected "
            f"0); peak memory {r['peak_gib']:.2f} GiB; losses {r['losses']}")
        if got != (want, 0):
            fail(f"Inception-v3 {label} arm launched {got}, expected "
                 f"({want}, 0)")
        if not inc_arms:
            k6_launches = k6.launches
        inc_arms.append((label, r))
    for label, r in inc_arms:
        log_arm(f"Inception {label}", r, args.batch_size, card)
    # Device time of the K6 and K1 arms.
    convlib.set_default_conv_impl("mxu")
    for knob, kid in (("1", "K6"), ("0", "K1")):
        os.environ["DTM_CONV_MXU_PIPELINE"] = knob
        phase_profile(inc_cfg, f"Inception-v3, {kid} convs")

    log(f"elapsed {time.perf_counter() - t_start:.1f} s after phase 7")

    # 8. K2-K5 against their plain versions, timed against their bounds.
    flash = phase_flash(args.seed + 2, parent)

    # 9. The transformer_lm path (pair backward), the flash counters zeroed
    # just before it and read just after; the blockwise yardstick after it.
    lm_cfg = get_config("transformer_lm")
    layers = lm_cfg.model_kwargs["num_layers"]
    tokens = lm_cfg.global_batch_size * lm_cfg.num_steps
    zero_counts(flash_fns.values())
    lm_run = run_lm_arm("transformer_lm", "flash", steps, workdir / "lm")
    lm_launches = {kid: fn.launches for kid, fn in flash_fns.items()}
    want = {kid: layers * steps if kid in ("K2", "K3", "K4") else 0
            for kid in flash_fns}
    log(f"flash launches in the transformer_lm run: {lm_launches} (expected "
        f"{want})")
    if lm_launches != want:
        fail(f"flash kernels launched {lm_launches}, expected {want}")
    log(f"transformer_lm (flash, K2-K4): {tokens} tokens a step, steps "
        f"{steps}, losses {lm_run['losses']}; peak memory "
        f"{lm_run['peak_gib']:.3f} GiB | {card}")
    # The blockwise arm (impl "auto"), which launches no flash kernel.
    zero_counts(flash_fns.values())
    lm_arms = [("flash", lm_run),
               ("auto", run_lm_arm("transformer_lm", "auto", steps,
                                   workdir / "lm1"))]
    got = {kid: fn.launches for kid, fn in flash_fns.items()}
    if got != dict.fromkeys(want, 0):
        fail(f"transformer_lm auto arm launched {got}, expected "
             f"{dict.fromkeys(want, 0)}")
    for label, r in lm_arms:
        log_arm(f"LM {label}", r, tokens, card)
    for impl, arm in (("flash", "transformer_lm, flash (K2-K4)"),
                      ("auto", "transformer_lm, blockwise attention")):
        phase_profile(lm_cfg.replace(attn_impl=impl), arm)

    # 10. The transformer_lm_modern path (rope, GQA 2/8, window 256) with
    # the staged backward: K2 and both K5 launches once per layer per step,
    # K3 and K4 never; then the pair backward in turns.
    mod_cfg = get_config("transformer_lm_modern")
    mod_layers = mod_cfg.model_kwargs["num_layers"]
    mod_tokens = mod_cfg.global_batch_size * mod_cfg.num_steps
    mod_arms = []
    for bwd in ("staged", "pair"):
        os.environ["DTM_FLASH_BWD"] = bwd
        zero_counts(flash_fns.values())
        r = run_lm_arm("transformer_lm_modern", "flash", steps,
                       workdir / f"modern{len(mod_arms)}")
        got = {kid: fn.launches for kid, fn in flash_fns.items()}
        on = ("K2", "K5 dKV", "K5 dQ") if bwd == "staged" else ("K2", "K3",
                                                                "K4")
        want = {kid: mod_layers * steps if kid in on else 0
                for kid in flash_fns}
        log(f"transformer_lm_modern, {bwd} backward: flash launches {got} "
            f"(expected {want}); peak memory {r['peak_gib']:.3f} GiB; losses "
            f"{r['losses']}")
        if got != want:
            fail(f"transformer_lm_modern ({bwd}) launched {got}, expected "
                 f"{want}")
        if not mod_arms:
            mod_launches = got
        mod_arms.append((bwd, r))
    for label, r in mod_arms:
        log_arm(f"modern {label}", r, mod_tokens, card)
    os.environ["DTM_FLASH_BWD"] = "staged"
    phase_profile(mod_cfg.replace(attn_impl="flash"),
                  "transformer_lm_modern, flash with the staged backward (K5)")
    os.environ["DTM_FLASH_BWD"] = "pair"

    # 11-13. The rest of the zoo: LeNet, ResNet-32 (f32 K1/K6), VGG-16,
    # AlexNet (bf16 K1) and the PTB LSTM.
    zoo = phases_zoo(steps, args.seed + 4, card, workdir)
    zk1, zpaths = zoo["k1"], zoo["paths"]
    log(f"elapsed {time.perf_counter() - t_start:.1f} s after phase 13")

    # 14. The decode path: the LM checkpoint's training (K2-K4, counters
    # zeroed just before), the CLI's generate, the decode at full width
    # and its logits against the K2 full forward.
    gen = phase_generate(card, workdir / "generate", flash_fns)

    # 15. The cold start from that checkpoint, with the startup thread on
    # and off, each arm a fresh process.
    phase_startup(card, workdir / "startup", gen["ckpt"])
    log(f"elapsed {time.perf_counter() - t_start:.1f} s after phase 15")

    # 16. The MoE transformer and the model knobs: remat (ResNet-50,
    # Inception-v3, the transformer), the embedding's matmul gradient and
    # blockwise q-chunking; every counter zeroed just before each run.
    knobs = phase_model_knobs(card, workdir / "knobs", flash_fns, k1, k6,
                              args.batch_size, args.seed + 5)
    log(f"elapsed {time.perf_counter() - t_start:.1f} s after phase 16")

    # 17. Tensor and sequence parallelism: the ring's per-rank arithmetic,
    # the restored rule set and the ring at axes of one (this slice's main
    # path: the flash counters zeroed just before each run, read after),
    # cnn_tp's split convolutions.
    par = phase_parallel(card, workdir / "parallel", flash_fns, k1,
                         args.batch_size, args.seed + 6)
    log(f"elapsed {time.perf_counter() - t_start:.1f} s after phase 17")

    # 18. Pipeline and expert parallelism: the pipelined schedule's and the
    # expert layout's per-rank arithmetic, the pipelined fit at a pipe axis
    # of one (this slice's main path: the flash counters zeroed just before
    # each run, read after) and the MoE fit at an expert axis of one.
    pipex = phase_pipe_expert(card, workdir / "pipe_expert", flash_fns,
                              args.seed + 7)
    log(f"elapsed {time.perf_counter() - t_start:.1f} s after phase 18")

    # 19. The async-PS vs sync A/B and its emulators on ResNet-50 (K1) and
    # transformer_lm (K2-K4), every counter zeroed at the phase's start and
    # read at its end.
    abx = phase_async(card, flash_fns, k1, k6, len(calls), args.batch_size)
    log(f"elapsed {time.perf_counter() - t_start:.1f} s after phase 19")

    # 20. The serving engine on transformer_lm: the decode path's
    # invariance, R1 against its plain version at the path's shapes, the
    # engine's traffic (R1's counter zeroed just before, read after)
    # against solo generate, the burst and speculation arms.
    serve = phase_serve(card, args.seed + 8)
    log(f"elapsed {time.perf_counter() - t_start:.1f} s after phase 20")

    log(card)
    kernels = [{
        "name": "K1 conv_implicit_gemm",
        "route": "cuda",
        "source": K1_SOURCE,
        "replaces": K1_REPLACES,
        "launches": k1_launches,
        "max_abs_err": k1_res["max_abs_err"],
        "ms": k1_res["ms"],
        "plain_ms": k1_res["plain_ms"],
        "bound_ms": k1_res["bound_ms"],
        "bound_by": k1_res["bound_by"],
        "library_ms": k1_res["library_ms"],
        "scope": f"sum over the {len(calls)} K1 launches of one ResNet-50 "
                 f"training step at batch {args.batch_size}; library: "
                 f"F.conv2d (cuDNN)",
        "at_inception_shapes_ms": k6_res["ms"],
        "at_vgg16_shapes_ms": zk1["VGG-16"]["ms"],
        "at_alexnet_shapes_ms": zk1["AlexNet"]["ms"],
        "launches_vgg16": zpaths["VGG-16"]["k1"][0],
        "launches_alexnet": zpaths["AlexNet"]["k1"][0],
        "launches_eval_resnet50": tel["k1_eval_launches"],
        "launches_chaos_resnet50": chaos["k1_launches"],
        "launches_chaos_relaunch_resnet50": chaos["k1_relaunch"],
        "launches_remat_resnet50": knobs["remat_resnet50_synthetic"][
            "k1_launches"],
        "launches_remat_inception_v3": knobs[
            "remat_inception_v3_imagenet"]["k1_launches"],
        "launches_cnn_tp_split": par["cnn_tp"]["launches"],
        "launches_async_ab_phase": abx["launches"]["K1"],
        "remat_launches_per_step": {
            "resnet50": knobs["remat_resnet50_synthetic"]["per_step"],
            "inception_v3": knobs["remat_inception_v3_imagenet"][
                "per_step"]},
    }, {
        "name": "K1 conv_implicit_gemm, f32 form (TF32 wgmma)",
        "route": "cuda",
        "source": K1_SOURCE,
        "replaces": K1_REPLACES,
        "launches": zpaths["ResNet-32"]["k1"][1],
        "max_abs_err": zk1["ResNet-32"]["max_abs_err"],
        "ms": zk1["ResNet-32"]["ms"],
        "plain_ms": zk1["ResNet-32"]["plain_ms"],
        "bound_ms": zk1["ResNet-32"]["bound_ms"],
        "bound_by": zk1["ResNet-32"]["bound_by"],
        "library_ms": zk1["ResNet-32"]["library_ms"],
        "scope": f"sum over the {zoo['shapes']['ResNet-32']} K1 launches "
                 f"of one resnet32_cifar10 training step at batch 128, f32; "
                 f"launches from the ResNet-32 K1 run (all f32); bound by "
                 f"the dense TF32 peak; library: F.conv2d in f32 with "
                 f"cudnn.allow_tf32=True",
    }]
    main_shape, sweep_shape, gqa_shape, d128_shape = (
        FLASH_SHAPES[n][0] for n in (0, 1, 2, 4))
    for kid, name, replaces in FLASH_KERNELS + STAGED_KERNELS:
        at_a = flash[kid]["timed"][main_shape]
        kernels.append({
            "name": f"{kid} {name}",
            "route": "cuda",
            "source": FLASH_SOURCE,
            "replaces": replaces,
            "launches": (mod_launches if kid.startswith("K5")
                         else lm_launches)[kid],
            "max_abs_err": flash[kid]["max_abs_err"],
            **at_a,
            "scope": "one launch at the LM path's shape B16 T256 H8 D32 "
                     "causal bf16; launches from the "
                     + ("transformer_lm_modern" if kid.startswith("K5")
                        else "transformer_lm") + " run; max_abs_err over "
                     "shapes a-e; library: "
                     + ("SDPA forward (events from Python)" if kid == "K2"
                        else "SDPA backward by CUDA-graph replay, which "
                        "computes dQ, dK and dV: compare with the sum of "
                        "the backward launches' device_ms"),
            "at_flash_sweep_shape": flash[kid]["timed"][sweep_shape],
            "at_gqa_window_shape": flash[kid]["timed"][gqa_shape],
            "at_d128_sweep_shape": flash[kid]["timed"][d128_shape],
        })
    k2_entry = next(k for k in kernels if k["name"].startswith("K2 "))
    k2_entry["launches_eval_transformer_lm"] = tel["k2_eval_launches"]
    k2_entry["launches_decode_check"] = gen["k2_decode_check"]
    for k in kernels:
        kid = k["name"].split(" ")[0]
        if kid in ("K2", "K3", "K4"):
            k["launches_generate_checkpoint"] = gen["train_launches"][kid]
            k["launches_transformer_lm_moe"] = knobs["moe_launches"][kid]
            k["launches_remat_transformer_lm"] = knobs[
                "remat_lm_launches"][kid]
            k["launches_tp_ring_fit"] = par["fit"]["launches"][kid]
            k["launches_ring_emulation"] = par["ring_launches"][kid]
            k["launches_pipelined_fit"] = pipex["fit"]["launches"][kid]
            k["launches_pipeline_emulation"] = pipex["emu_launches"][kid]
            k["launches_moe_expert1_fit"] = pipex["moe_fit"]["launches"][
                kid]
            k["launches_async_ab_phase"] = abx["launches"][kid]
    kernels[-1]["dq_vs_k4"] = flash["dq_vs_k4"]
    if parent is not None:
        kernels[-1]["dq_vs_k4_parent"] = flash["dq_vs_k4_parent"]
    kernels.append({
        "name": "K6 conv_implicit_gemm_pipelined",
        "route": "cuda",
        "source": K1_SOURCE,
        "replaces": K6_REPLACES,
        "launches": k6_launches,
        "max_abs_err": k6_res["max_abs_err"],
        "ms": k6_res["k6_ms"],
        "plain_ms": k6_res["plain_ms"],
        "bound_ms": k6_res["bound_ms"],
        "bound_by": k6_res["bound_by"],
        "library_ms": k6_res["library_ms"],
        "scope": f"sum over the {len(inc_calls)} conv core launches of one "
                 f"Inception-v3 training step at batch {args.batch_size}; "
                 f"equal to K1 bit for bit at every shape (K1 there: "
                 f"{k6_res['ms']:.3f} ms); library: F.conv2d (cuDNN)",
        "at_vgg16_shapes_ms": zk1["VGG-16"]["k6_ms"],
        "at_alexnet_shapes_ms": zk1["AlexNet"]["k6_ms"],
    })
    kernels.append({
        "name": "K6 conv_implicit_gemm_pipelined, f32 form (TF32 wgmma)",
        "route": "cuda",
        "source": K1_SOURCE,
        "replaces": K6_REPLACES,
        "launches": zpaths["ResNet-32"]["k6"][1],
        "max_abs_err": zk1["ResNet-32"]["max_abs_err"],
        "ms": zk1["ResNet-32"]["k6_ms"],
        "plain_ms": zk1["ResNet-32"]["plain_ms"],
        "bound_ms": zk1["ResNet-32"]["bound_ms"],
        "bound_by": zk1["ResNet-32"]["bound_by"],
        "library_ms": zk1["ResNet-32"]["library_ms"],
        "scope": "as the f32 K1 entry, launches from the ResNet-32 K6 arm "
                 "(DTM_CONV_MXU_PIPELINE=1); equal to the f32 K1 bit for "
                 "bit at every shape",
    })
    r1s, r1p = serve["r1_step"], serve["r1_prefill"]
    kernels.append({
        "name": "R1 row_matmul (row-invariant decode product)",
        "route": "cuda",
        "source": R1_SOURCE,
        "replaces": "none: added to keep the serving contract (a served "
                    "stream equals solo generate); the JAX package gets "
                    "it from XLA, distributed_tensorflow_models_tpu/"
                    "serving/engine.py:41",
        "launches": serve["r1_launches"],
        "max_abs_err": max(
            r1s["max_abs_err"], r1p["max_abs_err"],
            *(r[key]["max_abs_err"] for r in gen["paths"].values()
              for key in ("r1_step", "r1_prompt"))),
        "ms": r1s["ms"],
        "plain_ms": r1s["plain_ms"],
        "bound_ms": r1s["bound_ms"],
        "bound_by": r1s["bound_by"],
        "library_ms": r1s["library_ms"],
        "scope": f"sum over the {r1s['launches']} R1 launches of one [8, 1] "
                 f"transformer_lm decode step (the engine's 8 lanes); "
                 f"launches from phase 20's served traffic (phase 14's "
                 f"timed captured generate: launches_generate_phase); "
                 f"max_abs_err over every launch checked in phases 14 and "
                 f"20; library: torch.matmul on the same operands in "
                 f"their dtype",
        "launches_by_form": serve["r1_forms"],
        "launches_by_form_generate_phase": gen["r1_forms"],
        "bound_share_of_plain": max(
            r1s["bound_share"], r1p["bound_share"],
            *(r[key]["bound_share"] for r in gen["paths"].values()
              for key in ("r1_step", "r1_prompt"))),
        "launches_per_decode_step": r1s["launches"],
        "launches_per_prefill_dispatch": r1p["launches"],
        "launches_generate_phase": gen["r1_launches"],
        "generate_step_ms": {
            name: r["r1_step"]["ms"] for name, r in gen["paths"].items()},
        "generate_prompt_pass_ms": {
            name: r["r1_prompt"]["ms"] for name, r in gen["paths"].items()},
        "prefill_dispatch_ms": r1p["ms"],
        "prefill_dispatch_plain_ms": r1p["plain_ms"],
        "prefill_dispatch_bound_ms": r1p["bound_ms"],
        "prefill_dispatch_library_ms": r1p["library_ms"],
    })
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
