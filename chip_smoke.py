#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py [--out results.json]

Phases, each printed on its own line; any failure exits non-zero:

1. the card's name and power limit (``nvidia-smi``);
2. build every kernel of the serving and training paths from ``deeplearning_mpi_tpu_torch/csrc``
   (``nvcc -Xptxas -v`` output printed);
3. K1 (flash-attention forward) against its plain PyTorch version at the 110M
   widths: bf16 B8 S2048 H12 D64 causal, window 512 (both layouts) and
   window 300, the train step's call (BHSD views of BSHD storage, with the
   lse; also at a tp-4 rank's H3 and at the GPipe microbatch's B2 and B1),
   a ragged B2 S2000, D128 at S2048, f32
   S512, S 127 / 128 / 129, head dims 8 / 24 / 128, and the shift / lse /
   f32-output options; each output
   held element by element and in relative L2 (``FWD_TOL``), the lse to
   1e-4, and a second launch on the same inputs bit-identical;
4. K4 (flash-decode) against its plain version: B8, L1024 and L8192, H12, D64,
   Hkv 12 and 4, per-row fill levels including -1, 0 and L-1, windows, int8
   K/V; the serving shape with phase 6's fills, a tp-4 rank's H3 Hkv3
   (float32, those fills and seeded ones), head dims 8 / 24 / 128, a
   ragged L1000, fills on a split boundary of the kernel and either side of
   it, a window shorter than one split and one starting mid-split; each
   batch row of each output held element by element and in relative L2
   (``DEC_TOL``), inactive rows zero, and a second launch bit-identical;
5. serve a seeded random-init 110M ``TransformerConfig()`` (float32) through
   the continuous-batching engine and hold every stream token-identical to the
   port's offline greedy ``generate``; K1's and K4's launch counters are set
   to 0 just before and must both be above 0 just after; then replay the
   trace once more under ``torch.profiler`` for the device-busy share and the
   device time by kernel;
6. time K1 and K4 with CUDA events at the phase-5 shapes (K4 with the L2
   cold, and warm), beside their plain versions, the least time the card
   could take (``bound_ms``) and ``F.scaled_dot_product_attention`` as a
   yardstick (the port never calls it); K1 (as the train step calls it: bf16
   BHSD views of BSHD storage with the lse, beside SDPA's forward), K2 and
   K3 (beside SDPA's backward) at the phase-8 shape, timed after phase 9,
   since their launch counts come from phase 8; then K4 at L8192 (Hkv 12
   and 4) and ``decode_attention``'s dense schedule against K4 at B1 / B8,
   L 1024-8192, float32 and bf16 (``DECODE_DENSE_MAX``);
7. K2 and K3 (flash-attention backward) against their plain version: bf16
   B8 S2048 H12 D64 causal and window 512 in both layouts, causal at a tp-4
   rank's H3 (BHSD, as phase 15 calls them) and at the GPipe microbatch's
   B2 and B1 (phase 16), a ragged B2 S2000
   and a window of 300 (not a multiple of the kernels' 128-row blocks), f32
   S512, head dims 8 / 24 / 128, ragged S, and shift with window and float32
   grads; each gradient held element by element and in relative L2
   (``GRAD_TOL``), and a second launch on the same inputs bit-identical;
8. train the 110M ``TransformerConfig()`` at ``bench_lm``'s shape (bf16,
   ``flash_attention_bhsd``, B8 S2048, Adam 3e-4, clip 1.0) for 10 steps
   through ``make_train_step``, on 16 seeded synthetic sequences (vocab 32000)
   that the port's loader reshuffles each epoch: every loss finite and
   the last three below the first (a memorisation check on those 16
   sequences, not a measure of learning), K1/K2/K3 each launched exactly 12 times a
   step (counters set to 0 just before), the step-1 gradients of the flash
   path within bf16 tolerance of the dense path (B1 S2048, all 12 layers);
   the step time, tokens/s, MFU, peak memory and one profiled step;
9. the port's ``cli.train_lm`` at the 110M widths (vocab 256), seq 2048,
   batch 8, flash in bf16: must return 0;
10. checkpoint, resume, generate and serve at those widths and 4 of the 12
    blocks (``P10_MODEL``: its time is the full-state saves), in a temporary
    directory under ``build/``: (a) 2 epochs with ``--model_dir`` against 1
    epoch and a ``--resume`` to 2: equal epoch losses and final
    ``tree_digests`` bit for bit, K1/K2/K3 launched by the resumed run; (b)
    a save of the final state restored (verified) to the same digests, with
    its bytes and save / hash / restore seconds; (c) ``--eval_only`` reports
    the last eval loss; (d) a corrupted newest step: ``--resume`` rolls back
    to epoch 0 and retrains onto the same digests; (e) ``cli.generate
    --greedy --time`` token-identical to ``generate`` on the restored model,
    K1 and K4 launched, then one ``generate`` under ``torch.profiler``; (f) one beam equals greedy, and ``--num_beams 4
    --eos_id 10 --length_penalty 0.6`` equals ``beam_search``, K4 launched;
    (g) ``--prompts_file`` with 4 ragged prompts: each row's window equals
    its solo greedy run; (h) ``--quantize int8``: the share of tokens equal
    to the float stream's (no bar); (i) ``cli.serve_lm --model_dir
    --selftest`` exits 0, K4 launched;
11. the rest of the serving engine on the 110M widths at 4 of the 12
    blocks (``P11_LAYERS``), phase 5's seed and engine:
    (a) the prefix cache: 12 requests in 3 groups sharing 256-token prefixes
    (tails diverging mid-block, 2 repeated prompts), every stream equal to
    offline greedy, tokens reused and copy-on-write copies above 0, the
    pool's books balanced after a flush at drain; (b) speculative decoding,
    ``spec_k`` 4, on phase 5's trace: 2-layer and whole-model self-drafts,
    streams equal to offline greedy, proposed = accepted + rolled back, K4
    launched once a draft layer a draft step (and by the target's offline
    decode), the whole-model draft accepting every proposal; (c), while phase
    10's checkpoint exists: ``cli.serve_lm --model_dir --kv_dtype int8
    --selftest`` exits 0 at the 0.9 acceptance gate, K4 launched on int8
    pages; (d) a warmed engine (CUDA graphs) against the eager one, in
    turns: equal streams, no capture during traffic, K4's counted launches
    including the replays', TTFT / TPOT and the device-busy share of each;
    then K4 on int8 K/V timed at phase 6's serving decode shape;
12. the original workloads, in a temporary directory under ``build/``, each
    CLI joining NCCL at world size 1 through a file store there: (a)
    ``cli.hello_world`` (broadcast, single ring shift, round trip,
    all-reduce); (b) ``cli.train_resnet --synthetic``: ResNet-18 (imagenet
    stem, 10 classes, 11,181,642 parameters), global batch 128, SGD 0.1 /
    0.9 / 1e-5, 2048 samples for 2 epochs (32 steps), float32 then bf16;
    (c) ``cli.train_unet --synthetic``: the reference's UNet at full width,
    256x256, batch 16, Adam 1e-4 with clip 1.0, BCE, 160 samples (8 steps
    an epoch after the 20% split) for 2 epochs, float32 then bf16. Bars for
    each: every loss finite, the mean of the last three below the first
    (memorisation of a synthetic set), exactly one gradient all-reduce per
    optimizer step (``collectives.counts``), and, in float32, the card's
    step-1 loss within 1e-4 (relative) of a CPU copy's on the same weights
    and batch (ResNet B8, UNet B4, TF32 off) and every gradient within 1e-4
    relative L2 (the ResNet's in float32; the UNet's in float64, its
    float32 ones reported: a pre-activation near a ReLU's kink lands on
    opposite sides on the two devices). Reported: step median over steps
    3-end, images/s, MFU (the reference's FLOP counts over 67 TFLOP/s f32
    or 989 bf16), peak memory, eval accuracy / Dice, one profiled step's
    busy share and top device ops; (d) the float32 ResNet's checkpoint
    restored verified: ``tree_digests`` equal to the trained state's,
    ``batch_stats`` included, and ``--eval_only`` reports the last eval's
    accuracy;
13. the Mixture-of-Experts LM: ``TransformerConfig()`` at full width and
    depth with 8 routed experts of d_ff 2048 in every block (top 2,
    capacity factor 1.25, token choice). (a) 6 steps through
    ``make_train_step`` in bf16 with ``flash_attention_bhsd``, B8 S2048,
    Adam 3e-4 with clip 1.0, ``aux_weight`` 0.01, on 16 seeded sequences
    (vocab 32000): every loss finite and the last three below the first
    (memorisation), the load-balance loss finite and positive at every
    step, ``moe_dropped_frac`` reported, K1/K2/K3 each launched exactly 12
    times a step; the step median over steps 3-6, tokens/s, MFU counting
    the router and the 2 active experts, peak memory and one profiled step
    (busy share, top device ops, the MoE layer's forward stages), then two
    steps on uniformly random tokens (their dropped fraction and step
    time beside the motif steps'); (b) card
    against CPU at 2 layers, float32 (TF32 off), B1 S256, one seed's
    weights: every layer's dispatch mask equal, the step-1 loss within 1e-4
    relative and every gradient (router and expert stacks included) within
    1e-4 relative L2; (c) in a temporary directory under ``build/``,
    ``cli.train_lm --moe_experts 8`` at phase 10's shape with
    ``--model_dir`` exits 0 and logs ``moe_dropped_frac``;
    ``--moe_routing expert_choice`` exits 2 without
    ``--allow_acausal_routing`` and 0 with it (at 2 layers); ``cli.generate --moe_experts
    8 --greedy`` on the checkpoint is token-identical to ``generate`` on
    the restored model, K4 launched once a layer for each prompt position
    of the stepwise prefill and each new token after the first, K1 never;
    ``cli.serve_lm --moe_experts 8`` is refused with the reference's
    reason; (d) ``cli.train_lm --ep 1`` over NCCL at world size 1 (2
    layers at full width): the expert axis's wiring only, since NCCL
    refuses two ranks on one card;
14. sequence parallelism, bf16 at full width on one card through the
    one-process form of the schedules (``sp=4``: the ranks' steps in
    lockstep, since NCCL refuses two ranks on one card). (a) At B2 S8192 H12
    D64 (S_l 2048): the kernel ring (K1 each rotation with a float32 output
    and the lse, K2/K3 with the global lse and float32 gradients) causal,
    with window 512 (2 rotations), with GQA Hkv 4, non-causal, and in
    float32; Ulysses causal and with GQA Hkv 4. Each output and dq/dk/dv
    held to ``FWD_TOL`` / ``GRAD_TOL`` against the same schedule on the
    plain versions of K1-K3 and against one K1 / K2+K3 call over the whole
    sequence (with the schedule's rounding points), and a second run
    bit-identical. (b) The 110M ``TransformerConfig()`` at B2 S8192, Adam
    3e-4 with clip 1.0, with the ring as its attention fn against the same
    weights with ``flash_attention_bhsd`` over the whole sequence: step-1
    gradients within 5e-2 relative L2 per tensor, 4 steps of each with
    every loss finite and K1/K2/K3 launched exactly 120 times a step each
    for the ring (12 layers x (1+2+3+4) live blocks) and 12 for flash; step
    median, tokens/s, peak memory and one profiled step of each, no bar.
    (c) ``cli.train_lm --sp 1 --attention ring`` and ``ulysses`` over NCCL
    at world size 1 (2 layers, seq 4096: the wiring only) exit 0 with K1
    launched; ``--sp 2 --loss_chunk 256`` is no longer refused (one process
    exits 1 for want of a second seq rank; the chunked loss over seq
    shards is held on gloo ranks, ``tests/test_torch_compose_pipe.py``). Then
    K1/K2/K3 timed at the ring's past-block call (B2 S2048 H12 D64 bf16,
    non-causal, float32 output / gradients) beside their plain versions and
    SDPA's non-causal forward / backward;
15. tensor parallelism on one card through the one-process form
    (``LockstepTP``: the ranks in lockstep, since NCCL refuses two ranks on
    one card). (a) The 110M ``TransformerConfig()`` in bf16 at B8 S2048
    with flash, sharded over tp 4 (3 heads a rank), from phase 8's weights
    and batches: step-1 gradients gathered whole within 5e-2 relative L2
    per tensor of the unsharded flash step's, then 6 Adam steps (3e-4,
    clip 1.0) with every loss finite and K1/K2/K3 launched exactly 48
    times a step each (12 layers x 4 ranks); step median, tokens/s, peak
    memory and one profiled step, no bar. (b) ``TP_SHAPE`` under tp 2,
    float32 with TF32 off: the card's loss and step-1 gradients within
    1e-4 of the CPU's. (c) The 110M model in float32 (phase 5's weights)
    under tp 4: greedy generation token-identical to the unsharded model,
    K1 launched 48 times for the prefill and K4 48 times a decode step. (d)
    ``cli.train_lm --tp 1 --zero_overlap`` over NCCL at world size 1 (the
    wiring only) exits 0 and logs the reference's fallback reason ("no
    data parallelism"). Then K1/K2/K3 timed at the train step's shape at
    H3 and K4 at B8 L1024 H3 Hkv3, beside their plain versions and SDPA;
16. pipeline parallelism on one card through the one-process form
    (``LockstepPipe``: the stages tick by tick, since NCCL refuses two ranks
    on one card) and the ViT family. (a) The 110M ``TransformerConfig()``
    in bf16 at B8 S2048 with flash as ``PipelinedLM`` over 4 stages of 3
    blocks with 4 microbatches, from phase 8's weights and batches:
    step-1 gradients remapped flat within 5e-2 relative L2 per tensor of
    the flat flash step's, then 6 Adam steps (3e-4, clip 1.0) with every
    loss finite and K1/K2/K3 launched exactly 48 times a step each (12
    layers x 4 microbatches, at B2: no bubble work); step median, tokens/s,
    MFU, peak memory and one profiled step, no bar. (b) 4 layers at
    ``tiny()`` widths over 2 stages and 2 microbatches, float32 with TF32
    off: the card's loss and step-1 gradients within 1e-4 of the CPU's;
    ``tiny_moe`` the same way, its load-balance loss within 1e-5. (c)
    ``vit_small`` float32, TF32 off, B32: the card's gradients within 1e-4
    relative L2 of the CPU's; then ``cli.train_resnet --arch vit_small
    --synthetic --dtype bfloat16`` over NCCL at world size 1 with phase
    12's bars (finite, falling: memorisation; one gradient all-reduce a
    step; an eval): step median, images/s. Then K1/K2/K3 timed at the
    microbatch call (B2 S2048 H12 D64 bf16) beside their plain versions and
    SDPA;
17. the parallel axes composed on one card, in the one-process grid
    (``parallel.seq_common``: two lockstep axes side by side, each module
    calling its own), at 4 of the 12 blocks (``P17_LAYERS``; widths kept).
    (a) The 110M ``TransformerConfig()``'s widths in
    bf16 at B8 S2048 with flash as ``PipelinedLM`` over pp 2 x tp 2 with 4
    microbatches (K1/K2/K3 32 a step each: 4 layers x 4 microbatches x 2
    model ranks, at B2 H6); (b) tp 2 x sp 2 at B2 S8192 with the ring (24
    a step: 3 live blocks a layer and model rank) and with Ulysses (16: a
    whole-sequence call a layer, model rank and seq rank, at H3); (c)
    phase 13a's MoE LM (8 experts, top 2, capacity 1.25, balance loss
    0.01) with its routing shard by shard over 2 sequence shards (each
    shard's positions after the other's claims, capacity from the whole
    length) and the ring over them (12 a step); (d) the MoE LM over tp 2,
    attention and each expert's d_ff split (8 a step at H6). Each: step-1
    gradients gathered whole within 5e-2 relative L2 per tensor of the
    flat flash step's, 4 Adam steps (3e-4, clip 1.0) with every loss
    finite and falling (memorisation), the launch counts exact, a second
    2-step run bit-identical; step median, tokens/s, peak memory and one
    profiled step, no bar. (e) Ulysses at a tp-4 rank's 3 heads over sp 2
    (2 divides the model's 12 heads but not the rank's 3: the (batch,
    head)-pair all-to-all, K1-K3 on 3 single-head rows of the whole B2
    S8192 sequence, 2 calls each a forward and backward), held to
    ``FWD_TOL`` / ``GRAD_TOL`` as 14a. Then K1/K2/K3 timed at the new calls
    (B2 H6, B8 H6, Ulysses' B2 S8192 H3, its pairs' B3 S8192 H1, the ring's
    blocks B2 S4096 H6 and B8 S1024 H12) beside their plain versions and
    SDPA;
18. the parallel axes completed. (a) ``cli.train_lm --pp 2 --sp 2
    --attention ring`` and ``ulysses`` exit 1 with the reference's reason
    (its ring / Ulysses ``shard_map`` nested in the pipeline's is refused
    by JAX) and their ROADMAP item. (b) Phase 13a's MoE LM (8 experts, top
    2, balance loss 0.01) in bf16 at B8 S2048 as ``PipelinedLM`` over
    ``LockstepPipe(2)`` with 4 microbatches, every expert in this process
    (an expert group needs a process a rank: the four-card test splits
    them): step-1 gradients within 5e-2 relative L2 per tensor of the flat
    MoE model's flash step over the same 4 microbatches (each microbatch's
    balance loss, averaged: the reference's pipelined semantics), 4 Adam
    steps (3e-4, clip 1.0) finite and falling, K1/K2/K3 48 a step each (12
    layers x 4 microbatches), a second 2-step run bit-identical; step
    median, tokens/s, peak memory, one profiled step. (c) Adafactor (1e-3,
    clip 1.0) on 4 layers at ``d_model`` 256, ``d_ff`` 512 (factored
    moments), float32 with TF32 off, B4 S256, over ``LockstepTP(2)`` and
    over ``LockstepPipe(2)`` (2 microbatches), card (K1-K3) against CPU
    (their plain versions): the loss within 1e-4 relative, every step-1
    gradient within 1e-4 relative L2, every parameter's step delta within
    1e-3 relative L2 of the CPU's Adafactor update of the card's gradients
    (an unfactored leaf's first step is ``lr * g / |g|``: a gradient element
    near 0 flips it). Then K1/K2/K3 timed at 18b's microbatch call (B2
    S2048 H12) with 18b's launches;
19. telemetry. (a) ``cli.train_lm`` at the 110M widths (vocab 256) in bf16,
    B8 S2048, flash, 8 steps, with ``--metrics_dir --profile_dir --log_dir
    --metrics_every 1``, over NCCL at world size 1 in this process: every
    record canonical (``{"ts", "kind", ...}`` of JSON scalars; a summary's
    instruments in ``telemetry/schema.py``), the epoch record with the
    ``StepTimer`` keys, ``mfu`` and the ``hbm_*`` keys, ``hbm_peak_bytes``
    equal to ``torch.cuda.max_memory_allocated()``, the run log's sidecar
    equal to ``metrics.jsonl``, and the profiler trace holding K1, K2 and
    K3 exactly 12 times in each profiled step by their C++ names. (b) Phase
    8's step through the ``Trainer`` with the registry's step records off
    and on: the same synchronizing calls in every step under
    ``torch.cuda.set_sync_debug_mode``, both step times printed (no bar),
    the step's own sync sites printed; then with a span recorder the
    phases sum to the epoch's duration. (c) Phase 5's engine with a
    registry and a span recorder: every stream equal to offline greedy, 8
    TTFT and 8 TPOT observations, the registry's counters equal to
    ``engine.counters``, each request's queue + prefill + decode spans
    tiling arrival to finish within 1%; then ``serve_lm --selftest
    --metrics_file`` writes canonical records. 19b's steps make 0
    synchronizing calls (Adam's bias correction takes its bases as
    scalars);
20. the compiler layer. (a) Phase 8's step (110M, bf16, B8 S2048, flash,
    Adam 3e-4, clip 1.0) through a ``Trainer``, eager and captured
    (``Trainer.warmup``: one CUDA graph of the whole step), from the same
    weights over the same 6 batches (and one more step each for the sync
    count and one profiled): losses, parameters, Adam moments and
    ``count`` bitwise equal; the state after warmup bitwise the state
    before; one capture, none after warmup, no fallback; K1/K2/K3 12 a
    step through the replays; 0 synchronizing calls in an eager and in a
    replayed step; the registry's step records the step losses; step
    median and busy share of both arms reported, no bar. ``tiny_moe`` (8
    experts) and ``tiny`` under remat ``dots``, f32, captured against
    eager over 3 steps, bitwise, neither step making a sync. (b) A fresh ``python -c`` process loads every
    kernel library through ``compiler/cache.py``: 0 builds, 0 misses, a
    hit a library; ``verify()`` finds no bad digest. (c) ``cli.autotune
    --step 8x256 --spec_k 1`` on the card, then ``train_lm --tuned_step
    --aot_warmup`` at that shape applies the DB's schedule under a capture
    over 2 steps, and ``serve_lm --tuning_db --selftest`` (the tiny config,
    a 1-layer draft) takes the DB's ``spec_k``;
21. the resilience layer. (a) Phase 8's step (110M, bf16, B8 S2048,
    flash, Adam 3e-4, clip 1.0) with an EMA, warmed into one CUDA graph, 3
    epochs of 2 steps under ``utils.config.execute`` (``max_restarts`` 2)
    with ``kill@step:5,corrupt_ckpt@epoch:1,loader_stall@batch:1``, then
    without a plan: parameters, Adam moments, ``count`` and EMA bitwise the
    unfaulted run's, history [0, 1, 1, 2] with the unfaulted epoch losses,
    books 3 = 2 + 1, K1/K2/K3 12 a step over the 9 steps run, no capture
    after warmup, no eager step; the 110M save and verified-restore seconds.
    (b) At 4 of the 12 blocks: ``nan_grad@step:1`` leaves the state after
    step 1 bitwise the state before; under ``--guardrails`` a
    ``loss_spike@step:9`` is judged poisoned, rolled back to the pinned
    epoch 1 and replayed bitwise onto the unfaulted run (one rollback); the
    chaos-hooked loop makes 0 synchronizing calls a step with guardrails
    off. (c) ``train_lm --chaos kill@step:3,corrupt_ckpt@epoch:0
    --max_restarts 2 --log_dir --aot_warmup`` at phase 19's widths (4
    blocks) exits 0
    with a balanced ``run_summary`` and ``heartbeat.json`` at the final
    step; ``--chaos serve_crash@step:1`` exits 1 naming the workload;
22. the serving half of the resilience layer. (a) Phase 5's engine and
    trace with ``serve_crash@step:3,serve_crash@step:9``, eager then warmed:
    every stream equal to offline greedy, books 2 = 2 + 0, requeued work,
    K1 (the engine's prefill chunks) and K4 launched. (b) The disaggregated
    pair at full depth on that trace, eager, warmed, and warmed with
    ``handoff_stall@step:4``: streams equal to offline greedy, handoffs equal
    to the requests with more than one new token, no K4 launch inside a
    prefill-role step and no K1 launch inside a decode-role step, the KV
    pools never moved, the shared pool drained, the books balanced. (c)
    ``serve_lm --selftest`` through a fleet at the 110M widths (vocab 256, 2
    of the 12 blocks), its three runs and (d) side by side: ``--replicas 2 --chaos
    replica_kill@step:4,replica_hang@step:6 --swap_at 8`` (re-dispatched,
    swapped in place with no capture, streams under both weight versions),
    ``--replicas 2 --hedge_ms 60 --chaos replica_slow@step:2`` (hedges
    fired), ``--autoscale --min_replicas 1 --max_replicas 3 --chaos
    load_spike@step:2,scale_during_failure@step:1`` (a scale-up, zero drops):
    each exits 0 with its bit-exact parity, one stream a rid, every worker
    that served reporting K1 and K4 launches since its ready ack; each
    replica's start-up split by stage. (d) ``cli.controlplane_drill``
    there: the supervisor SIGKILLs itself mid-surge, the restarted one
    re-adopts every live replica with no respawn, the books balance across
    incarnations, parity holds. Then K1 at the prefill-chunk call (held to
    ``FWD_TOL``, its bound the chunk's own work) and K4 at the serving
    decode shape, timed with phase 22's launches;
23. the last modules. (a) The sanitizer (``DMT_SANITIZE=1``): 21a's faulted
    run's saves of the 110M captured state under the donation canary and
    22a's eager and warmed engines (K1, K4) with 0 trips; then on a fresh
    tiny warmed engine on the card (``cli.sanitize_drill``) each injection
    (double free, use after free, refcount underflow, a write to a shared
    block, a capture after warmup, an eager decode at an uncaptured width,
    a save racing an in-place ``add_``) raised, classified, counted once
    and mirrored into the registry. (b) ``sim.FleetSimulator`` on 22c's
    ``--autoscale`` trace with 22c's ``AutoscalerConfig``, its
    ``ServiceModel`` calibrated from that run's records (TTFT before any
    fault, the workers' TPOT median, spawn -> ready): 64 completions and 0
    sheds in both, a scale-up in each, the simulated TTFT p50 within the
    reference calibration test's band (1.5 / 10.5 to 21.0 / 10.5) of the
    measured one. (c) 12b on the native C++ transforms and the loader's
    default fetch threads, every 12b bar held. (d) Before the
    ``flash_decode`` join: seeded ``.pth`` files (torchvision ResNet-18
    names with DDP's prefix; the reference UNet, 2 and 1 classes) through
    ``cli.import_torch --device cuda``; the restored models' eval logits
    within 1e-5 relative L2 of a functional oracle (f32, TF32 off); then
    ``train_resnet --resume --torch_padding --eval_only`` and ``train_unet
    --resume --reference_topology --eval_only`` on the imports.

Order: all kernel builds start together; phases 3, 7, 8, 9, 12, 16 and 23d
(no K4) run while ``flash_decode.cu`` still builds, then 4, 5, 6, 10, 11,
13-15, 17-23 and the training-shape timing rows. 13c's CLIs run 4 of the MoE LM's 12 blocks.

The second-to-last lines are the kernel table (one JSON object) and the
card's name and power limit; the last line is the result JSON. Without CUDA,
or without the package beside this file, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import argparse
import gc
import itertools
import json
import math
import os
import re
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

#: Published peaks of one H100 SXM (dense): bf16 tensor cores, float32 on the
#: CUDA cores (the f32 path must not round through TF32), HBM bandwidth.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12


#: (phase, seconds) of each phase's closing line, as logged
PHASE_SECONDS: list[tuple[str, float]] = []


def log(msg: str) -> None:
    print(msg, flush=True)
    closing = re.match(r"phase (\d+) .* in ([0-9.]+)s$", msg)
    if closing:
        PHASE_SECONDS.append((closing.group(1), float(closing.group(2))))


def gpu_name_and_power() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device milliseconds per call over ``iters`` calls, by CUDA
    events. A sleep kernel queued first holds the card while the host
    enqueues every call, so the host's launch overhead (tens of
    microseconds a call, more than a small kernel runs) is not timed —
    unless ``fn`` itself waits for the card, as a plain version that reads
    a device value on the host does."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)  # ~50 ms at the H100's clock
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def close(got, want, tol: float) -> bool:
    """|got - want| <= tol * (1 + |want|) everywhere: bf16 outputs differ by
    up to one rounding of the output itself (2**-8 relative), so the bound
    grows with the value."""
    return bool(((got.float() - want.float()).abs() <= tol * (1 + want.float().abs())).all())


#: Phase 7's bound on K2/K3 by input dtype, ``(atol, rtol, l2)``: every
#: element within ``atol + rtol * |want|`` and each tensor within ``l2``
#: relative L2 error. In bf16 the kernel and the plain version round p and
#: ds at the same points, but a probability near a rounding boundary may
#: round the other way; in the first rows, which see few keys, p is near 1
#: and one such flip moves a small gradient by 2**-8 |do| (3.9e-3 at a value
#: under 0.1 on the H100), hence the atol. The relative L2 error is what
#: holds the kernel: 8e-5 to 1.7e-4 on the card at S2048, against 3e-2 and
#: more for a kernel that drops one tile or is 3% off
#: (``tests/test_torch_flash_bwd.py``).
GRAD_TOL = {"bfloat16": (1e-2, 2e-2, 5e-3), "float32": (1e-4, 1e-4, 1e-4)}


def grads_close(got, want, atol: float, rtol: float, l2: float,
                scale=None) -> tuple[bool, float, float]:
    """``(within the bound, max abs err, relative L2 err)`` of one tensor (a
    gradient in phase 7, K1's output in phase 3). ``scale``: the size the
    elementwise bound's ``rtol`` is taken of, in place of ``|want|``: for a
    sum of rounded terms, the sum of their magnitudes (:func:`terms_scale`)."""
    diff, ref = got.float() - want.float(), want.float()
    rel = float(diff.norm() / ref.norm().clamp(min=1e-30))
    size = ref.abs() if scale is None else ref.abs().maximum(scale.float())
    ok = bool((diff.abs() <= atol + rtol * size).all()) and rel <= l2
    return ok, float(diff.abs().max()), rel


def terms_scale(terms, groups: int):
    """``sum |term|`` over each run of ``groups`` adjacent heads (dim 2) of
    a ``[B, S, H, D]`` tensor of per-head terms: the size of the sum that a
    grouped K/V's backward makes of them (GQA's repeat summed back). Each
    term is rounded to its dtype before the sum, so where the terms cancel
    the sum's error is a rounding of the terms', not of the small sum; a
    bound relative to ``|sum|`` alone then rejects a right kernel."""
    t = terms.float().abs()
    return t.reshape(*t.shape[:2], -1, groups, t.shape[-1]).sum(3)


def require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


# -- phase 3 -----------------------------------------------------------------
#: Phase 3's bound on K1 by input dtype, ``(atol, rtol, l2)``, in the form of
#: ``GRAD_TOL``: every element of the output within ``atol + rtol * |want|``
#: and the whole output within ``l2`` relative L2 error. The elementwise
#: bound alone is close to empty at S2048, where a row of a random attention
#: output is about 0.03 in size: the old ``2e-2 (1 + |want|)`` passes an
#: output 3% low past its first rows. The card's run of the previous K1
#: (``mma.sync``, 64-row blocks) on these cases (H100) gave, in bf16, max abs
#: errors up to 7.8e-3 and relative L2 errors of 2.9e-4 to 1.8e-3 (the
#: online softmax rounds p against the running max, the plain version
#: against the row's max); in float32 up to 3.4e-7 and 4.7e-8 to 2.1e-7. A
#: K1 that drops a kv tile, reads a stale V stage or is 3% low is at 3e-2
#: and more (``tests/test_torch_flash_fwd.py``).
FWD_TOL = {"bfloat16": (1e-2, 2e-2, 5e-3), "float32": (1e-5, 1e-5, 1e-5)}


#: The GPipe microbatch calls (phase 16: B8 over ``--microbatches`` 4, and
#: 8), in the form of ``check_k1``'s / ``check_k2k3``'s cases. They draw from
#: the shared generator, after the cases above: phase 14a then runs on the
#: draws under which its Ulysses GQA case once failed the elementwise bound
#: taken of ``|want|`` (``terms_scale``).
K1_PP_CASES = [(f"bf16 causal bhsd views lse B{b} (pp microbatch)", b, 2048, 12, 64, "bfloat16",
                {"return_lse": True}, "views") for b in (2, 1)]
K2K3_PP_CASES = [(f"bf16 causal bhsd B{b} (pp microbatch)", b, 2048, 12, 64, "bfloat16", {},
                  "bhsd") for b in (2, 1)]


def check_k1(torch, gen, cases=None) -> None:
    """K1 against its plain version: each output held to ``FWD_TOL`` by its
    input dtype, the lse to 1e-4 where finite, and a second launch on the
    same inputs bit-identical (``cases``: the list below by default)."""
    from deeplearning_mpi_tpu_torch.ops.kernels import flash_attention as fa

    bf16, f32 = torch.bfloat16, torch.float32
    cases = [(*c[:5], getattr(torch, c[5]), *c[6:]) for c in cases] if cases else [
        # (name, B, S, H, D, dtype, kwargs, layout); "views": BHSD views of
        # BSHD storage, as the model passes them in training.
        ("bf16 causal", 8, 2048, 12, 64, bf16, {}, "bshd"),
        ("bf16 causal bhsd views lse", 8, 2048, 12, 64, bf16, {"return_lse": True}, "views"),
        # The same call at a tp-4 rank's local heads (phase 15's training).
        (f"bf16 causal bhsd views lse H{12 // P15_TP} (tp {P15_TP} rank)", 8, 2048, 12 // P15_TP,
         64, bf16, {"return_lse": True}, "views"),
        ("bf16 window512", 8, 2048, 12, 64, bf16, {"window": 512}, "bshd"),
        ("bf16 window512 bhsd", 8, 2048, 12, 64, bf16, {"window": 512}, "bhsd"),
        ("bf16 window300", 8, 2048, 12, 64, bf16, {"window": 300}, "bshd"),
        ("bf16 causal ragged S2000", 2, 2000, 12, 64, bf16, {}, "bshd"),
        ("bf16 D128 causal S2048", 2, 2048, 12, 128, bf16, {}, "bhsd"),
        ("f32 causal S512", 8, 512, 12, 64, f32, {}, "bshd"),
        ("f32 full S300", 2, 300, 4, 64, f32, {"causal": False}, "bshd"),
        ("f32 D128 causal S200", 1, 200, 2, 128, f32, {}, "bhsd"),
        ("f32 D8 window S77", 2, 77, 3, 8, f32, {"window": 9}, "bshd"),
        ("bf16 D24 causal S90", 2, 90, 3, 24, bf16, {}, "bhsd"),
        ("bf16 D128 full S200", 1, 200, 2, 128, bf16, {"causal": False}, "bshd"),
        ("bf16 shift lse f32-out", 2, 200, 3, 64, bf16,
         {"window": 64, "shift": 100, "return_lse": True, "out_dtype": f32}, "bshd"),
        ("f32 shift lse", 1, 130, 2, 64, f32,
         {"window": 40, "shift": 150, "return_lse": True}, "bhsd"),
    ] + [(f"{str(dt)[6:]} causal S{S}", 2, S, 4, 64, dt, {}, "bshd")
         for S in (127, 128, 129) for dt in (bf16, f32)]
    for name, B, S, H, D, dtype, kw, layout in cases:
        atol, rtol, l2 = FWD_TOL[str(dtype)[6:]]
        shape = (B, H, S, D) if layout == "bhsd" else (B, S, H, D)
        q, k, v = (torch.randn(*shape, generator=gen, device="cuda").to(dtype) for _ in range(3))
        if layout == "views":
            q, k, v = (t.transpose(1, 2) for t in (q, k, v))
        call = dict(causal=kw.get("causal", True), window=kw.get("window"),
                    shift=kw.get("shift", 0), return_lse=kw.get("return_lse", False),
                    out_dtype=kw.get("out_dtype"), layout="bshd" if layout == "bshd" else "bhsd")
        with_lse = (lambda x: x) if call["return_lse"] else (lambda x: (x, None))
        (got, got_lse), (again, again_lse) = (
            with_lse(fa.flash_attention_cuda(q, k, v, **call)) for _ in range(2))
        torch.cuda.synchronize()
        want, want_lse = with_lse(fa.flash_attention_reference(q, k, v, **call))
        require(torch.equal(got, again) and (got_lse is None or torch.equal(got_lse, again_lse)),
                f"K1 {name}: a second launch on the same inputs differs")
        lse_note = ""
        if got_lse is not None:
            finite = want_lse > -1e29
            require(torch.equal(finite, got_lse > -1e29), f"K1 {name}: lse masked rows differ")
            lse_err = max_err(got_lse[finite], want_lse[finite])
            lse_note = f", lse {lse_err:.3e} (tol 1e-4)"
            require(lse_err <= 1e-4, f"K1 {name}: lse max abs err {lse_err}")
        require(got.dtype == want.dtype, f"K1 {name}: dtype {got.dtype} != {want.dtype}")
        require(bool(torch.isfinite(got).all()), f"K1 {name}: non-finite output")
        ok, err, rel = grads_close(got, want, atol, rtol, l2)
        bound = f"bound atol {atol:g} + rtol {rtol:g}, rel L2 {l2:g}"
        log(f"K1 {name}: max abs err {err:.3e}, rel L2 {rel:.3e}{lse_note} ({bound}); "
            f"bit-identical on a second launch")
        require(ok, f"K1 {name}: max abs err {err}, rel L2 {rel}, {bound}")


# -- phase 4 -----------------------------------------------------------------
#: Phase 4's bound on K4 by q dtype, ``(atol, rtol, l2)``, in the form of
#: ``FWD_TOL``, held by each batch row (one request) through ``grads_close``
#: (``decode_close``): every element within ``atol + rtol * |want|`` and
#: each row's output ``[H, D]`` within ``l2`` relative L2 error. Per row,
#: because rows differ in size by orders of magnitude (a row of one key
#: outputs a V row, a row of 8000 keys an average ~90x smaller), so the
#: whole batch's L2 follows its shortest rows and is blind to a long one.
#: In bf16 the kernel and the plain version round p to bf16 at the same
#: point but against different maxima (a 32-row chunk's, a 1024-row
#: block's): 2.3e-3 to 3.4e-3 for the worst row of each bf16 case on the
#: CPU stand-in of the split kernel, 2.3e-3 to 3.5e-3 for the kernel on the
#: H100, against 0.13 and more for a K4 that drops a row's last 64-row
#: chunk or loses a split, and 3e-2 for an output 3% low
#: (``python -m tests.test_torch_flash_decode``; the kernel's:
#: ``cli/probe_decode.py``). float32: up to 6.1e-7 on the H100.
DEC_TOL = {"bfloat16": (1e-2, 2e-2, 1e-2), "float32": (1e-5, 1e-5, 1e-5)}


def decode_close(got, want, atol: float, rtol: float, l2: float) -> tuple[bool, float, float]:
    """``grads_close`` on each batch row of a K4 output ``[B, 1, H, D]``:
    ``(every row within the bound, max abs err, largest row's relative L2
    err)``."""
    rows = [grads_close(g, w, atol, rtol, l2) for g, w in zip(got, want)]
    return all(r[0] for r in rows), max(r[1] for r in rows), max(r[2] for r in rows)


#: The serving trace of phase 5: prompt lengths and new tokens per request.
SERVE_PROMPTS, SERVE_NEW = (128, 512, 200, 384, 160, 448, 256, 320), 32


#: The engine of phases 5 and 11.
SERVE_ENGINE = dict(max_slots=8, block_size=16, max_blocks_per_seq=64, num_blocks=320,
                    prefill_chunk=128)


def serve_trace(vocab: int, seed: int) -> list[dict]:
    """Phase 5's trace: ``SERVE_PROMPTS`` of seeded tokens, Poisson 50/s."""
    import numpy as np

    rng = np.random.default_rng(seed)
    entries, t = [], 0.0
    for n in SERVE_PROMPTS:
        t += float(rng.exponential(1.0 / 50.0))
        entries.append({"arrival": t, "max_new": SERVE_NEW,
                        "prompt": rng.integers(1, vocab, size=n).astype(np.int32)})
    return entries


def serve_fills() -> list[int]:
    """K4's per-row fill levels at the middle of phase 5's generation."""
    return [n + SERVE_NEW // 2 - 1 for n in SERVE_PROMPTS]


def k4_cases(split: int) -> list[tuple]:
    """Phase 4's cases: ``(name, B, L, H, Hkv, D, dtype, window, int8,
    fills)``; ``fills`` None draws B seeded fill levels with rows 1, 2 and 3
    set to -1, 0 and L-1. ``split`` is K4's split length: fills sit on a
    split boundary and one either side of it, windows end inside one split
    or start mid-split."""
    import torch

    f32, bf16 = torch.float32, torch.bfloat16
    cases = [
        (f"L{L} Hkv{hkv} {str(dt)[6:]} window={w} int8={qt}", 8, L, 12, hkv, 64, dt, w, qt, None)
        for L in (1024, 8192) for hkv in (12, 4) for dt in (f32, bf16)
        for w, qt in ((None, False), (300, False), (None, True), (500, True))
    ]
    cases.append(("serving shape L1024 Hkv12 float32", 8, 1024, 12, 12, 64, f32, None, False,
                  serve_fills()))
    # A tp-4 rank's local heads (phase 15's generation), at phase 5's fills
    # and at seeded ones.
    h = 12 // P15_TP
    for fills in (serve_fills(), None):
        cases.append((f"tp {P15_TP} rank L1024 H{h} Hkv{h} float32 fills "
                      f"{'serving' if fills else 'seeded'}", 8, 1024, h, h, 64, f32, None, False,
                      fills))
    for D in (8, 24, 128):
        for dt in (f32, bf16):
            cases.append((f"D{D} L1024 Hkv4 {str(dt)[6:]}", 8, 1024, 12, 4, D, dt, None, False, None))
    for dt in (f32, bf16):
        cases.append((f"ragged L1000 Hkv12 {str(dt)[6:]}", 8, 1000, 12, 12, 64, dt, None, False,
                      None))
    for L in (1024, 8192):
        boundary = [split - 1, split, split + 1, 0, -1, L - 1, 3 * split + 7, 2 * split]
        for w in (None, split // 2 + 5, 2 * split + 37):
            for dt in (f32, bf16):
                cases.append((f"split edges L{L} Hkv4 {str(dt)[6:]} window={w}", 8, L, 12, 4, 64,
                              dt, w, False, boundary))
    return cases


def k4_inputs(torch, gen, fd, case) -> tuple:
    """Seeded ``(q, k, v, index, scales)`` on the card for one of
    ``k4_cases``."""
    name, B, L, H, hkv, D, dtype, window, quant, fills = case
    q = torch.randn(B, 1, H, D, generator=gen, device="cuda").to(dtype)
    k = torch.randn(B, L, hkv, D, generator=gen, device="cuda").to(dtype)
    v = torch.randn(B, L, hkv, D, generator=gen, device="cuda").to(dtype)
    if fills is None:
        index = torch.randint(0, L, (B,), generator=gen, device="cuda")
        index[1], index[2], index[3] = -1, 0, L - 1
    else:
        index = torch.tensor(fills, device="cuda")
    scales = {}
    if quant:
        k, ks = fd.quantize_kv(k)
        v, vs = fd.quantize_kv(v)
        scales = {"k_scale": ks, "v_scale": vs}
    return q, k, v, index.to(torch.int32), scales


def check_k4(torch, gen) -> None:
    """K4 against its plain version: each row of each output held to
    ``DEC_TOL`` by q dtype, inactive rows zero, one launch counted per call,
    and a second launch on the same inputs bit-identical."""
    from deeplearning_mpi_tpu_torch.ops.kernels import flash_decode as fd

    for case in k4_cases(fd.SPLIT_ROWS):
        name, dtype, window = case[0], case[6], case[7]
        atol, rtol, l2 = DEC_TOL[str(dtype)[6:]]
        q, k, v, index, scales = k4_inputs(torch, gen, fd, case)
        before = fd.flash_decode_cuda.launches
        got, again = (fd.flash_decode_cuda(q, k, v, index, window=window, **scales)
                      for _ in range(2))
        torch.cuda.synchronize()
        require(fd.flash_decode_cuda.launches == before + 2, f"K4 {name}: launches not counted")
        require(torch.equal(got, again), f"K4 {name}: a second launch on the same inputs differs")
        want = fd.flash_decode_reference(q, k, v, index, window=window, **scales)
        require(got.dtype == want.dtype, f"K4 {name}: dtype {got.dtype} != {want.dtype}")
        require(bool(torch.isfinite(got).all()), f"K4 {name}: non-finite")
        dead = (index < 0).nonzero().flatten().tolist()
        require(all(bool((got[b] == 0).all()) for b in dead), f"K4 {name}: inactive row not zero")
        ok, err, rel = decode_close(got, want, atol, rtol, l2)
        bound = f"bound atol {atol:g} + rtol {rtol:g}, rel L2 {l2:g} a row"
        log(f"K4 {name}: max abs err {err:.3e}, rel L2 {rel:.3e} (worst row; {bound}); "
            f"bit-identical on a second launch")
        require(ok, f"K4 {name}: max abs err {err}, rel L2 {rel}, {bound}")


# -- phase 5 -----------------------------------------------------------------
def serve(torch, seed: int):
    from deeplearning_mpi_tpu_torch.cli.serve_lm import latency_report, offline_greedy, replay
    from deeplearning_mpi_tpu_torch.models.transformer import TransformerConfig, TransformerLM
    from deeplearning_mpi_tpu_torch.ops.kernels.flash_attention import flash_attention_cuda
    from deeplearning_mpi_tpu_torch.ops.kernels.flash_decode import flash_decode_cuda
    from deeplearning_mpi_tpu_torch.serving import EngineConfig, ServingEngine

    cfg = TransformerConfig()  # the 110M model at full width and depth
    model = TransformerLM(cfg, dtype=torch.float32, device="cuda").init_weights(seed)
    entries = serve_trace(cfg.vocab_size, seed)
    engine_cfg = EngineConfig(**SERVE_ENGINE)
    engine = ServingEngine(model, engine_cfg)
    flash_attention_cuda.launches = 0
    flash_decode_cuda.launches = 0
    t0 = time.perf_counter()
    reqs, wall_s = replay(engine, entries)
    torch.cuda.synchronize()
    rep = latency_report(reqs, wall_s)
    expects = [offline_greedy(model, r.prompt, r.max_new_tokens, None) for r in reqs]
    torch.cuda.synchronize()
    launches = {"K1": flash_attention_cuda.launches, "K4": flash_decode_cuda.launches}
    log(f"serve: {json.dumps(rep)} | phase {time.perf_counter() - t0:.1f}s | "
        f"launches {launches} | {engine.decode_steps} decode steps, "
        f"{engine.prefill_chunks} prefill chunks")
    streams_equal(model, reqs, expects, "serve")
    require(launches["K1"] > 0 and launches["K4"] > 0, f"serve: kernel not launched: {launches}")
    log(f"serve OK: {len(reqs)} streams token-identical to offline greedy")
    profile = profile_replay(torch, ServingEngine(model, engine_cfg), entries)
    # Shapes the main path gave each kernel, for phase 6.
    k1_shape = (1, max(SERVE_PROMPTS), cfg.num_heads, cfg.head_dim)
    width = 1
    while width < -(-max(n + SERVE_NEW for n in SERVE_PROMPTS) // 16):
        width *= 2
    return launches, k1_shape, serve_fills(), min(width, 64) * 16, profile


def profile_replay(torch, engine, entries) -> dict:
    """Replay the trace again on a fresh engine under ``torch.profiler``
    (the profiler slows the host, so its latencies are not phase 5's)."""
    from deeplearning_mpi_tpu_torch.cli.serve_lm import replay

    return device_profile(torch, lambda: replay(engine, entries), "profile")


def device_profile(torch, fn, label: str) -> dict:
    """Run ``fn`` under ``torch.profiler``; returns the device-busy share of
    its wall time (the union of the device events' intervals over the host
    clock, synchronised at the end) and the device time by kernel name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    # Device events, less the device-side spans of ``record_function``
    # ranges (the MoE layer's ``moe/*``): a span covers the gaps between its
    # kernels, which are not device work.
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)
              and not e.name.startswith("moe/")]
    busy_us, end = 0.0, float("-inf")
    for start, stop in sorted((e.time_range.start, e.time_range.end) for e in device):
        busy_us += max(0.0, stop - max(start, end))
        end = max(end, stop)
    by_name: dict[str, list] = {}
    for e in device:
        entry = by_name.setdefault(e.name, [0.0, 0])
        entry[0] += (e.time_range.end - e.time_range.start) / 1e3
        entry[1] += 1
    top = sorted(by_name.items(), key=lambda kv: kv[1][0], reverse=True)[:10]
    # The port's own kernels, wherever they rank (their C++ names).
    port: dict[str, list] = {}
    for name, (ms, calls) in by_name.items():
        for kernel in ("fwd_kernel", "bwd_kernel", "dq_kernel", "dkv_kernel", "delta_kernel",
                       "decode_kernel"):
            if re.search(rf"\b{kernel}<", name):
                entry = port.setdefault(kernel, [0.0, 0])
                entry[0] += ms
                entry[1] += calls
    # The MoE layer's forward stages (its ``moe/*`` ranges on the host): device
    # ms of the kernels each launched.
    stages: dict[str, list] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CPU and e.name.startswith("moe/"):
            entry = stages.setdefault(e.name, [0.0, 0])
            entry[0] += getattr(e, "device_time_total", 0.0) / 1e3
            entry[1] += 1
    summary = {"wall_s": wall_s, "device_busy_s": busy_us / 1e6,
               "busy_share": busy_us / 1e6 / wall_s, "device_events": len(device),
               "top": [{"name": n, "device_ms": ms, "calls": c} for n, (ms, c) in top],
               "port": {k: {"device_ms": ms, "calls": c} for k, (ms, c) in sorted(port.items())},
               "stages": {k: {"device_ms": ms, "calls": c}
                          for k, (ms, c) in sorted(stages.items())}}
    require(len(device) > 0, f"{label}: no device events traced")
    log(f"{label}: wall {wall_s:.4f}s, device busy {busy_us / 1e6:.4f}s "
        f"({100 * summary['busy_share']:.2f}%), {len(device)} device events")
    for t in summary["top"]:
        log(f"{label}: {t['device_ms']:9.3f} ms {t['calls']:6d} x {t['name'][:110]}")
    for k, t in summary["port"].items():
        log(f"{label}: the port's {k}: {t['device_ms']:.3f} ms in {t['calls']} launches")
    for k, t in summary["stages"].items():
        log(f"{label}: forward range {k}: {t['device_ms']:.3f} ms of device time in "
            f"{t['calls']} calls")
    return summary


# -- phase 6 -----------------------------------------------------------------
def k4_row(torch, gen, launches: int, fills, k4_len: int, heads: int = 12,
           name: str = "K4 flash_decode") -> dict:
    """K4's row at ``fills`` over an ``[B, k4_len, heads, 64]`` float32
    cache: L2-cold (8 buffer pairs in turn) and warm, beside its plain
    version and SDPA with the fill mask."""
    import torch.nn.functional as F

    from deeplearning_mpi_tpu_torch.ops.kernels import flash_decode as fd

    B, H, D = len(fills), heads, 64
    q = torch.randn(B, 1, H, D, generator=gen, device="cuda")
    bufs = [(torch.randn(B, k4_len, H, D, generator=gen, device="cuda"),
             torch.randn(B, k4_len, H, D, generator=gen, device="cuda")) for _ in range(8)]
    index = torch.tensor(fills, dtype=torch.int32, device="cuda")
    filled = sum(f + 1 for f in fills)
    nbytes = (2 * filled * H * D + 2 * B * H * D) * 4
    flops = 4 * filled * H * D
    pos = torch.arange(k4_len, device="cuda")
    mask = (pos[None, :] <= index[:, None].long())[:, None, None, :]
    sdpa = [(kb.transpose(1, 2), vb.transpose(1, 2)) for kb, vb in bufs]
    qs = q.transpose(1, 2)

    def cold(fn, pairs):
        turn = itertools.cycle(pairs)
        return time_ms(lambda: fn(*next(turn)))

    return {
        "name": name, "route": "cuda",
        "source": "deeplearning_mpi_tpu_torch/csrc/flash_decode.cu",
        "replaces": "deeplearning_mpi_tpu/ops/pallas/flash_decode.py:100",
        "launches": launches,
        "max_abs_err": max_err(fd.flash_decode_cuda(q, *bufs[0], index),
                               fd.flash_decode_reference(q, *bufs[0], index)),
        "ms": cold(lambda kb, vb: fd.flash_decode_cuda(q, kb, vb, index), bufs),
        "warm_ms": time_ms(lambda: fd.flash_decode_cuda(q, *bufs[0], index)),
        "plain_ms": cold(lambda kb, vb: fd.flash_decode_reference(q, kb, vb, index), bufs),
        "bound_ms": max(flops / PEAK_FLOPS["float32"], nbytes / PEAK_BYTES) * 1e3,
        "bound_by": "operations" if flops / PEAK_FLOPS["float32"] > nbytes / PEAK_BYTES else "bytes",
        "library_ms": cold(lambda ks, vs: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask),
                           sdpa),
        "shape": f"B{B} L{k4_len} H{H} Hkv{H} D{D} float32 fills {fills}, L2-cold",
    }


def time_kernels(torch, gen, launches, k1_shape, fills, k4_len) -> list[dict]:
    import torch.nn.functional as F

    from deeplearning_mpi_tpu_torch.ops.kernels import flash_attention as fa

    rows = []
    # K1 at the offline prefill shape: one prompt, causal, float32.
    B, S, H, D = k1_shape
    q, k, v = (torch.randn(B, S, H, D, generator=gen, device="cuda") for _ in range(3))
    kw = dict(causal=True, window=None, shift=0, return_lse=False, out_dtype=None, layout="bshd")
    pairs = B * H * S * (S + 1) // 2
    flops, nbytes = 4 * D * pairs, 4 * B * S * H * D * 4
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    k1 = {
        "name": "K1 flash_attention_fwd (f32 prefill)", "route": "cuda",
        "source": "deeplearning_mpi_tpu_torch/csrc/flash_attention_fwd.cu",
        "replaces": "deeplearning_mpi_tpu/ops/pallas/flash_attention.py:110",
        "launches": launches["K1"],
        "max_abs_err": max_err(fa.flash_attention_cuda(q, k, v, **kw),
                               fa.flash_attention_reference(q, k, v, **kw)),
        "ms": time_ms(lambda: fa.flash_attention_cuda(q, k, v, **kw)),
        "plain_ms": time_ms(lambda: fa.flash_attention_reference(q, k, v, **kw)),
        "bound_ms": max(flops / PEAK_FLOPS["float32"], nbytes / PEAK_BYTES) * 1e3,
        "bound_by": "operations" if flops / PEAK_FLOPS["float32"] > nbytes / PEAK_BYTES else "bytes",
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)),
        "shape": f"B{B} S{S} H{H} D{D} float32 causal",
    }
    rows.append(k1)
    # K4 at the engine's decode shape: every slot active at a mid-run fill,
    # L2-cold: 8 buffer pairs in turn (126 MB of filled rows a round, the L2
    # holds 50), as the engine's 12 layers each read their own cache; warm
    # (one pair, its 15.7 MB read from L2) beside it.
    rows.append(k4_row(torch, gen, launches["K4"], fills, k4_len))
    for r in rows:
        warm = f" (warm {r['warm_ms']:.4f})" if "warm_ms" in r else ""
        log(f"time {r['name']} [{r['shape']}]: kernel {r['ms']:.4f} ms{warm}, plain "
            f"{r['plain_ms']:.4f} ms, sdpa {r['library_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
    return rows


def time_extra(torch, gen) -> dict:
    """K4 at the 110M model's longest cache, L8192 with every row full, with
    Hkv 12 and 4 (400 and 134 MB a call: cold by size), beside SDPA with the
    fill mask (the Hkv-4 K/V repeated to 12 heads first); then
    ``decode_attention``'s two schedules (``DECODE_DENSE_MAX``): the one
    masked matmul over the whole buffer against K4, B1 and B8, L 1024 to
    8192, float32 and bf16, every row full, L2-cold (buffer pairs in turn,
    120 MB or more a round). Reported, not in the kernel table."""
    from deeplearning_mpi_tpu_torch.ops.attention import decode_attention
    from deeplearning_mpi_tpu_torch.ops.kernels import flash_decode as fd

    import torch.nn.functional as F

    from deeplearning_mpi_tpu_torch.ops.attention import repeat_kv

    L, out = 8192, {"long": [], "dense_vs_k4": []}
    for hkv in (12, 4):
        q = torch.randn(8, 1, 12, 64, generator=gen, device="cuda")
        kb = torch.randn(8, L, hkv, 64, generator=gen, device="cuda")
        vb = torch.randn(8, L, hkv, 64, generator=gen, device="cuda")
        index = torch.full((8,), L - 1, dtype=torch.int32, device="cuda")
        # SDPA with the fill mask; Hkv 4 on K/V repeated to 12 heads before
        # the timed calls (the repeat itself is not timed).
        ks, vs = (repeat_kv(t, 12 // hkv).transpose(1, 2) for t in (kb, vb))
        mask = torch.ones(8, 1, 1, L, dtype=torch.bool, device="cuda")
        qs = q.transpose(1, 2)
        r = {"what": f"K4 f32 B8 L{L} H12 Hkv{hkv} D64 full fill",
             "ms": time_ms(lambda: fd.flash_decode_cuda(q, kb, vb, index)),
             "plain_ms": time_ms(lambda: fd.flash_decode_reference(q, kb, vb, index)),
             "library_ms": time_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs,
                                                                          attn_mask=mask)),
             "bound_ms": (2 * 8 * L * hkv * 64 + 2 * 8 * 12 * 64) * 4 / PEAK_BYTES * 1e3}
        log(f"time {r['what']}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
            f"sdpa with mask {r['library_ms']:.4f} ms (Hkv {hkv} repeated to 12), bound "
            f"{r['bound_ms']:.4f} ms")
        out["long"].append(r)
        del q, kb, vb, ks, vs
    for dtype in (torch.float32, torch.bfloat16):
        for B in (1, 8):
            for L in (1024, 2048, 4096, 8192):
                pair = 2 * B * L * 12 * 64 * dtype.itemsize
                q = torch.randn(B, 1, 12, 64, generator=gen, device="cuda").to(dtype)
                bufs = [tuple(torch.randn(B, L, 12, 64, generator=gen, device="cuda").to(dtype)
                              for _ in range(2)) for _ in range(max(1, -(-120_000_000 // pair)))]

                def timed(use_kernel):
                    turn = itertools.cycle(bufs)
                    return time_ms(lambda: decode_attention(q, *next(turn), L - 1, dense_max=L,
                                                            use_kernel=use_kernel))

                r = {"B": B, "L": L, "dtype": str(dtype)[6:], "dense_ms": timed(False),
                     "k4_ms": timed(True), "copies": len(bufs)}
                log(f"time decode_attention {r['dtype']} B{B} L{L} full: dense "
                    f"{r['dense_ms']:.4f} ms, K4 {r['k4_ms']:.4f} ms")
                out["dense_vs_k4"].append(r)
                del q, bufs
    return out


# -- phase 7 -----------------------------------------------------------------
def check_k2k3(torch, gen, cases=None) -> None:
    """K2 and K3 against their plain version on the same o, do and lse (o and
    lse from K1), over cases that mirror phase 3 (``cases``: the list below
    by default)."""
    from deeplearning_mpi_tpu_torch.ops.kernels import flash_attention as fa

    bf16, f32 = torch.bfloat16, torch.float32
    cases = [(*c[:5], getattr(torch, c[5]), *c[6:]) for c in cases] if cases else [
        # (name, B, S, H, D, input dtype, kwargs, layout); bound GRAD_TOL[dtype]
        ("bf16 causal", 8, 2048, 12, 64, bf16, {}, "bshd"),
        ("bf16 causal bhsd", 8, 2048, 12, 64, bf16, {}, "bhsd"),
        (f"bf16 causal bhsd H{12 // P15_TP} (tp {P15_TP} rank)", 8, 2048, 12 // P15_TP, 64, bf16,
         {}, "bhsd"),
        ("bf16 window512", 8, 2048, 12, 64, bf16, {"window": 512}, "bshd"),
        ("bf16 window512 bhsd", 8, 2048, 12, 64, bf16, {"window": 512}, "bhsd"),
        ("bf16 causal ragged S2000", 2, 2000, 12, 64, bf16, {}, "bshd"),
        ("bf16 window300 bhsd", 8, 2048, 12, 64, bf16, {"window": 300}, "bhsd"),
        ("f32 causal S512", 8, 512, 12, 64, f32, {}, "bshd"),
        ("f32 full S300", 2, 300, 4, 64, f32, {"causal": False}, "bhsd"),
        ("f32 D8 window S77", 2, 77, 3, 8, f32, {"window": 9}, "bshd"),
        ("bf16 D24 causal S90", 2, 90, 3, 24, bf16, {}, "bhsd"),
        ("f32 D128 causal S200", 1, 200, 2, 128, f32, {}, "bhsd"),
        ("bf16 D128 full S200", 1, 200, 2, 128, bf16, {"causal": False}, "bshd"),
        ("bf16 window shift f32-grads", 2, 200, 3, 64, bf16,
         {"window": 64, "shift": 100, "grad_dtype": f32}, "bshd"),
        ("f32 window shift", 1, 130, 2, 64, f32, {"window": 40, "shift": 150}, "bhsd"),
    ]
    for name, B, S, H, D, dtype, kw, layout in cases:
        atol, rtol, l2 = GRAD_TOL[str(dtype)[6:]]
        shape = (B, S, H, D) if layout == "bshd" else (B, H, S, D)
        q, k, v, do = (torch.randn(*shape, generator=gen, device="cuda").to(dtype)
                       for _ in range(4))
        call = dict(causal=kw.get("causal", True), window=kw.get("window"),
                    shift=kw.get("shift", 0), layout=layout)
        o, lse = fa.flash_attention_cuda(q, k, v, return_lse=True, out_dtype=None, **call)
        call["grad_dtype"] = kw.get("grad_dtype")
        dq, delta = fa.flash_attention_bwd_dq_cuda(q, k, v, o, do, lse, **call)
        dk, dv = fa.flash_attention_bwd_dkv_cuda(q, k, v, o, do, lse, delta, **call)
        again = fa.flash_attention_bwd(q, k, v, o, do, lse, **call)
        torch.cuda.synchronize()
        require(all(torch.equal(a, b) for a, b in zip((dq, dk, dv), again)),
                f"K2/K3 {name}: a second launch on the same inputs differs")
        want = fa.flash_attention_bwd_reference(q, k, v, o, do, lse, **call)
        errs, bound = [], f"bound atol {atol:g} + rtol {rtol:g}, rel L2 {l2:g}"
        for label, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
            require(got.dtype == ref.dtype, f"K2/K3 {name}: {label} dtype {got.dtype} != {ref.dtype}")
            require(bool(torch.isfinite(got).all()), f"K2/K3 {name}: non-finite {label}")
            ok, err, rel = grads_close(got, ref, atol, rtol, l2)
            errs.append(f"{label} {err:.3e}/{rel:.3e}")
            require(ok, f"K2/K3 {name}: {label} max abs err {err}, rel L2 {rel}, {bound}")
        log(f"K2/K3 {name}: max abs err / rel L2: {', '.join(errs)} ({bound}); "
            f"bit-identical on a second launch")


# -- phase 8 -----------------------------------------------------------------
def train_110m(torch, seed: int) -> dict:
    """The 110M ``TransformerConfig()`` at ``bench_lm``'s shape: bf16, flash
    attention (K1/K2/K3), B8 S2048, Adam 3e-4 with clip 1.0, 10 steps (5
    epochs of 2 batches) through the port's loader and ``make_train_step``."""
    import numpy as np

    from deeplearning_mpi_tpu_torch.data import Loader, SyntheticTokens
    from deeplearning_mpi_tpu_torch.models.transformer import TransformerConfig, TransformerLM
    from deeplearning_mpi_tpu_torch.ops.kernels import flash_attention as fa
    from deeplearning_mpi_tpu_torch.telemetry.flops import transformer_train_flops
    from deeplearning_mpi_tpu_torch.train import (
        build_optimizer,
        create_train_state,
        make_train_step,
    )

    cfg = TransformerConfig()
    B, S, steps = 8, 2048, 10
    model = TransformerLM(cfg, dtype=torch.bfloat16, device="cuda").init_weights(seed)
    # 16 sequences through the port's loader: 2 batches an epoch, 5 epochs,
    # reshuffled each epoch (fresh random 32k-token motifs in every batch
    # would leave 10 steps nothing to learn).
    loader = Loader(SyntheticTokens(2 * B, S, vocab_size=cfg.vocab_size, seed=seed), B,
                    shuffle=True, seed=seed, device="cuda")
    batches = [b for epoch in range(steps // 2) for b in loader.epoch(epoch)]

    # Step-1 gradients, flash against dense, on the init params and batch 0
    # at B1 (the dense path's [B, 12, S, S] scores at B8 would not fit).
    def grads(attention_fn):
        model.zero_grad(set_to_none=True)
        from deeplearning_mpi_tpu_torch.ops.loss import lm_cross_entropy

        tokens = batches[0]["tokens"][:1]
        lm_cross_entropy(model(tokens, attention_fn=attention_fn), tokens).backward()
        return {n: p.grad.float().clone() for n, p in model.named_parameters()}

    g_flash, g_dense = grads(fa.flash_attention_bhsd), grads(None)
    model.zero_grad(set_to_none=True)
    rel = {n: float((g_flash[n] - g_dense[n]).norm() / g_dense[n].norm().clamp(min=1e-30))
           for n in g_dense}
    worst = max(rel, key=rel.get)
    log(f"train: flash vs dense step-1 grads (B1 S{S}, {len(rel)} tensors): relative L2 error "
        f"max {rel[worst]:.3e} ({worst}), median {sorted(rel.values())[len(rel) // 2]:.3e} "
        f"(tol 5e-2)")
    require(rel[worst] <= 5e-2, f"train: flash grads differ from dense: {worst} {rel[worst]}")
    del g_flash, g_dense

    state = create_train_state(model, build_optimizer("adam", 3e-4, clip_norm=1.0),
                               attention_fn=fa.flash_attention_bhsd)
    step = make_train_step("lm")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in (fa.flash_attention_cuda, fa.flash_attention_bwd_dq_cuda,
               fa.flash_attention_bwd_dkv_cuda):
        fn.launches = 0
    losses, times = [], []
    for batch in batches:
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
    launches = {"K1": fa.flash_attention_cuda.launches,
                "K2": fa.flash_attention_bwd_dq_cuda.launches,
                "K3": fa.flash_attention_bwd_dkv_cuda.launches}
    peak = torch.cuda.max_memory_allocated()
    step_s = sorted(times[2:])[len(times[2:]) // 2]
    flops = transformer_train_flops(cfg, B, S)
    result = {"losses": losses, "step_times_s": times, "step_s_median": step_s,
              "tokens_per_s": B * S / step_s, "model_flops_per_step": flops,
              "mfu": flops / step_s / PEAK_FLOPS["bfloat16"], "max_memory_allocated": peak,
              "launches": launches}
    log(f"train: losses {[round(x, 4) for x in losses]}")
    log(f"train: step median {1e3 * step_s:.2f} ms (steps 3-10), {result['tokens_per_s']:.0f} "
        f"tokens/s, MFU {100 * result['mfu']:.2f}% of 989 TFLOP/s ({flops:.4e} model FLOPs a "
        f"step), max_memory_allocated {peak / 2**30:.2f} GiB, launches {launches}")
    require(all(np.isfinite(losses)), f"train: non-finite loss {losses}")
    require(sum(losses[-3:]) / 3 < losses[0], f"train: loss did not fall: {losses}")
    require(all(n == 12 * steps for n in launches.values()),
            f"train: expected {12 * steps} launches of each kernel, got {launches}")
    result["profile"] = device_profile(
        torch, lambda: step(state, batches[-1]), "train profile (one step)")
    return result


# -- phase 9 -----------------------------------------------------------------
def train_cli() -> None:
    """The port's training CLI at the 110M widths (vocab 256, as the JAX
    CLI), seq 2048, batch 8, flash attention in bf16: 5 steps and an eval."""
    from deeplearning_mpi_tpu_torch.cli import train_lm

    rc = train_lm.main([
        "--device", "cuda", "--attention", "flash", "--dtype", "bfloat16",
        "--num_layers", "12", "--d_model", "768", "--num_heads", "12", "--head_dim", "64",
        "--d_ff", "2048", "--seq_len", "2048", "--batch_size", "8",
        "--train_sequences", "48", "--num_epochs", "1",
    ])
    require(rc == 0, f"train_lm CLI exited {rc}")


def time_training(torch, gen, launches, heads: int = 12, where: str = "phase 8",
                  batch: int = 8, seq: int = 2048, label: str | None = None) -> list[dict]:
    """K1, K2 and K3 at the phase-8 shape (bf16 B8 S2048 H12 D64 causal;
    ``heads``: a tensor-parallel rank's local heads, phase 15; ``batch``: a
    GPipe microbatch's rows, phase 16).
    K1 as the train step calls it (BHSD views of BSHD storage, with the lse)
    beside the forward of ``F.scaled_dot_product_attention``; K2 and K3 on
    BHSD tensors beside the plain backward and SDPA's backward (the pair's
    yardstick, timed once and reported in both rows). The port never calls
    SDPA."""
    import torch.nn.functional as F

    from deeplearning_mpi_tpu_torch.ops.kernels import flash_attention as fa

    B, H, S, D = batch, heads, seq, 64
    pairs = B * H * S * (S + 1) // 2
    tensor = B * H * S * D * 2  # one bf16 [B, H, S, D] tensor
    rowvec = B * H * S * 4  # one float32 [B, H, S] vector
    rows = []
    tag = "" if heads == 12 else f", tp {12 // heads} local heads"
    tag += "" if batch == 8 else f", B{batch}"
    tag += "" if seq == 2048 else f", S{seq}"
    tag = tag if label is None else f", {label}"

    def row(name, source, replaces, fn, flops, nbytes, **fields):
        t_ops, t_bytes = flops / PEAK_FLOPS["bfloat16"], nbytes / PEAK_BYTES
        rows.append({
            "name": name, "route": "cuda", "source": f"deeplearning_mpi_tpu_torch/csrc/{source}",
            "replaces": f"deeplearning_mpi_tpu/ops/pallas/flash_attention.py:{replaces}",
            "ms": time_ms(fn), "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops > t_bytes else "bytes", **fields,
        })

    # K1 as the train step calls it.
    views = [torch.randn(B, S, H, D, generator=gen, device="cuda").bfloat16().transpose(1, 2)
             for _ in range(3)]
    fwd = dict(causal=True, window=None, shift=0, return_lse=True, out_dtype=None, layout="bhsd")
    o, _ = fa.flash_attention_cuda(*views, **fwd)
    want, _ = fa.flash_attention_reference(*views, **fwd)
    row(f"K1 flash_attention_fwd (bf16 train{tag})", "flash_attention_fwd.cu", 110,
        lambda: fa.flash_attention_cuda(*views, **fwd), 4 * D * pairs, 4 * tensor + rowvec,
        launches=launches["K1"], max_abs_err=max_err(o, want),
        plain_ms=time_ms(lambda: fa.flash_attention_reference(*views, **fwd), iters=3, warmup=1),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(*views, is_causal=True)),
        shape=f"B{B} S{S} H{H} D{D} bf16 causal, BHSD views of BSHD, lse")
    del o, want

    q, k, v, do = (torch.randn(B, H, S, D, generator=gen, device="cuda").bfloat16()
                   for _ in range(4))
    kw = dict(causal=True, window=None, shift=0, grad_dtype=None, layout="bhsd")
    o, lse = fa.flash_attention_cuda(q, k, v, return_lse=True, out_dtype=None,
                                     **{n: kw[n] for n in ("causal", "window", "shift", "layout")})
    dq, delta = fa.flash_attention_bwd_dq_cuda(q, k, v, o, do, lse, **kw)
    dk, dv = fa.flash_attention_bwd_dkv_cuda(q, k, v, o, do, lse, delta, **kw)
    want = fa.flash_attention_bwd_reference(q, k, v, o, do, lse, **kw)
    plain_ms = time_ms(lambda: fa.flash_attention_bwd_reference(q, k, v, o, do, lse, **kw),
                       iters=3, warmup=1)
    qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
    out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
    sdpa_ms = time_ms(lambda: torch.autograd.grad(out, (qs, ks, vs), do, retain_graph=True))
    shared = dict(plain_ms=plain_ms, library_ms=sdpa_ms,
                  shape=f"B{B} S{S} H{H} D{D} bf16 causal bhsd")
    row(f"K2 flash_attention_bwd_dq{tag}", "flash_attention_bwd.cu", 338,
        lambda: fa.flash_attention_bwd_dq_cuda(q, k, v, o, do, lse, **kw),
        6 * D * pairs, 6 * tensor + rowvec, launches=launches["K2"],
        max_abs_err=max_err(dq, want[0]), **shared)
    row(f"K3 flash_attention_bwd_dkv{tag}", "flash_attention_bwd.cu", 386,
        lambda: fa.flash_attention_bwd_dkv_cuda(q, k, v, o, do, lse, delta, **kw),
        8 * D * pairs, 6 * tensor + 2 * rowvec, launches=launches["K3"],
        max_abs_err=max(max_err(dk, want[1]), max_err(dv, want[2])), **shared)
    for r in rows:
        plain = "plain" if r["name"].startswith("K1") else "plain (dq+dk+dv)"
        sdpa = "sdpa forward" if r["name"].startswith("K1") else "sdpa backward (dq+dk+dv)"
        log(f"time {r['name']} [{r['shape']}]: kernel {r['ms']:.4f} ms, {plain} "
            f"{r['plain_ms']:.4f} ms, {sdpa} {r['library_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}), {r['launches']} launches in {where}")
    return rows


# -- phase 10 ----------------------------------------------------------------
#: Phase 10's model flags: the 110M widths at vocab 256 (phase 9's), 4 of
#: the 12 blocks: the phase's time is its full-state saves and restores, and
#: its bars hold at any depth.
P10_MODEL = ["--num_layers", "4", "--d_model", "768", "--num_heads", "12", "--head_dim", "64",
             "--d_ff", "2048"]
#: Its training: seq 2048, batch 8, flash in bf16; 24 sequences (22 train:
#: 2 steps an epoch; 2 eval), so each epoch's checkpoint is a full-size state.
P10_TRAIN = P10_MODEL + ["--device", "cuda", "--attention", "flash", "--dtype", "bfloat16",
                         "--seq_len", "2048", "--batch_size", "8", "--train_sequences", "24"]
P10_PROMPT = ("Checkpoints are written atomically, verified by their digests and restored "
              "onto the card before any decode step.")
P10_PROMPTS = ["A short one.", "Two prompts of another length, both ASCII.",
               "Ragged rows switch from their prompt to their own samples at their own length.",
               P10_PROMPT]
P10_NEW = 64


def checkpoint_phase(torch, card: str, then=None) -> dict:
    """Train, checkpoint, verify, resume, then generate and serve from the
    checkpoint, through the port's CLIs at the 110M widths (10a-10i); then
    ``then(model_dir)`` (phase 11c) while the checkpoint still exists."""
    import contextlib
    import io
    import shutil
    import tempfile

    import numpy as np

    from deeplearning_mpi_tpu_torch.cli import generate as gen_cli
    from deeplearning_mpi_tpu_torch.cli import serve_lm, train_lm
    from deeplearning_mpi_tpu_torch.models.generate import beam_search, generate
    from deeplearning_mpi_tpu_torch.models.transformer import TransformerConfig
    from deeplearning_mpi_tpu_torch.ops.kernels import flash_attention as fa
    from deeplearning_mpi_tpu_torch.ops.kernels import flash_decode as fd
    from deeplearning_mpi_tpu_torch.resilience import corrupt_checkpoint, dir_digests, tree_digests
    from deeplearning_mpi_tpu_torch.train.checkpoint import Checkpointer
    from deeplearning_mpi_tpu_torch.utils.config import restore_lm

    kernels = {"K1": fa.flash_attention_cuda, "K2": fa.flash_attention_bwd_dq_cuda,
               "K3": fa.flash_attention_bwd_dkv_cuda, "K4": fd.flash_decode_cuda}

    def zero(*names):
        for n in names:
            kernels[n].launches = 0

    def read(*names):
        torch.cuda.synchronize()
        return {n: kernels[n].launches for n in names}

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="phase10-", dir=os.path.join(ROOT, "build"))
    out: dict = {"card": card}
    try:
        a_dir, b_dir = os.path.join(work, "a"), os.path.join(work, "b")
        # 10a: 2 epochs uninterrupted; 1 epoch, then --resume to 2.
        a = train_lm.train(P10_TRAIN + ["--num_epochs", "2", "--model_dir", a_dir])
        saved = tree_digests(a.state.arrays())
        b = train_lm.train(P10_TRAIN + ["--num_epochs", "1", "--model_dir", b_dir])
        zero("K1", "K2", "K3")
        b2 = train_lm.train(P10_TRAIN + ["--num_epochs", "2", "--model_dir", b_dir, "--resume"])
        launches = read("K1", "K2", "K3")
        same = tree_digests(b2.state.arrays()) == saved
        losses = {"a": [h["loss"] for h in a.history], "b": [b.history[0]["loss"]],
                  "b_resumed": [h["loss"] for h in b2.history]}
        log(f"10a resume: losses {json.dumps(losses)}; final digests equal: {same}; "
            f"resumed run's launches {launches}")
        require(b.history[0]["loss"] == a.history[0]["loss"], "10a: epoch 0 losses differ")
        require(b2.history[-1]["loss"] == a.history[1]["loss"],
                "10a: the resumed epoch 1 loss differs from the uninterrupted run's")
        require(same, "10a: the resumed run's final state differs from the uninterrupted run's")
        require(all(n > 0 for n in launches.values()), f"10a: kernel not launched: {launches}")
        out["resume"] = {"losses": losses, "launches": launches}
        shutil.rmtree(b_dir)
        # 10b: a save of A's final state, hashed and restored (verified).
        ck = Checkpointer(os.path.join(work, "timing"))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ck.save(a.state, epoch=0)
        save_s = time.perf_counter() - t0
        nbytes = sum(os.path.getsize(os.path.join(ck.step_dir(0), f))
                     for f in os.listdir(ck.step_dir(0)))
        t0 = time.perf_counter()
        dir_digests(ck.step_dir(0))
        hash_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        restored, _ = ck.restore_verified(b2.state)  # b2's buffers, overwritten
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        require(tree_digests(restored.arrays()) == saved,
                "10b: the restored state's digests differ from the saved state's")
        out["checkpoint"] = {"bytes": nbytes, "save_s": save_s, "hash_s": hash_s,
                             "restore_verified_s": restore_s}
        log(f"10b checkpoint: {nbytes} bytes, save {save_s:.3f}s, hash {hash_s:.3f}s, "
            f"verified restore {restore_s:.3f}s; restored digests equal the saved [{card}]")
        del b, b2, restored
        shutil.rmtree(ck.directory)
        # 10c: --eval_only reports run A's last eval loss.
        ev = train_lm.train(P10_TRAIN + ["--num_epochs", "2", "--model_dir", a_dir, "--eval_only"])
        log(f"10c eval_only: loss {ev.history[0]['loss']!r}, run A's last eval "
            f"{a.history[-1]['eval_loss']!r}")
        require(ev.history[0]["loss"] == a.history[-1]["eval_loss"],
                "10c: --eval_only's loss differs from run A's last eval")
        # 10d: a corrupted newest step: --resume rolls back to epoch 0.
        corrupt_checkpoint(os.path.join(a_dir, "lm", "1"))
        captured = io.StringIO()
        with contextlib.redirect_stdout(captured):
            d = train_lm.train(P10_TRAIN + ["--num_epochs", "2", "--model_dir", a_dir, "--resume"])
        for line in captured.getvalue().splitlines():
            log(f"10d | {line}")
        require("checkpoint epoch 1 CORRUPT — rolling back" in captured.getvalue()
                and "resumed from verified epoch 0" in captured.getvalue(),
                "10d: no rollback to epoch 0")
        require(tree_digests(d.state.arrays()) == saved,
                "10d: the rolled-back, retrained state differs from run A's")
        del a, d, ev
        # 10e: cli.generate --greedy from the checkpoint against the library.
        gen_argv = P10_MODEL + ["--device", "cuda", "--model_dir", a_dir,
                                "--max_new_tokens", str(P10_NEW)]
        cfg = TransformerConfig(vocab_size=256, num_layers=int(P10_MODEL[1]), num_heads=12,
                                head_dim=64, d_model=768, d_ff=2048)
        model = restore_lm(cfg, dtype=torch.float32, device=torch.device("cuda"),
                           model_dir=a_dir)
        prompt = torch.tensor([list(P10_PROMPT.encode())], device="cuda")
        zero("K1", "K4")
        greedy = gen_cli.run(gen_argv + ["--prompt", P10_PROMPT, "--greedy", "--time"])
        launches = read("K1", "K4")
        want = generate(model, prompt, max_new_tokens=P10_NEW, temperature=0.0).cpu().numpy()
        log(f"10e greedy: {greedy.timing}; launches {launches}")
        require(np.array_equal(greedy.tokens, want), "10e: cli.generate differs from generate")
        require(launches["K1"] > 0 and launches["K4"] > 0, f"10e: kernel not launched: {launches}")
        out["greedy"] = {"timing": greedy.timing, "launches": launches,
                         "profile": device_profile(
                             torch, lambda: generate(model, prompt, max_new_tokens=P10_NEW,
                                                     temperature=0.0), "10e decode profile")}
        # 10f: one beam is greedy; 4 beams with EOS and a length penalty.
        one = beam_search(model, prompt, max_new_tokens=P10_NEW, num_beams=1).cpu().numpy()
        require(np.array_equal(one, want), "10f: beam_search with one beam differs from greedy")
        zero("K1", "K4")
        beams = gen_cli.run(gen_argv + ["--prompt", P10_PROMPT, "--num_beams", "4", "--eos_id",
                                        "10", "--length_penalty", "0.6", "--time"])
        launches = read("K1", "K4")
        lib = beam_search(model, prompt, max_new_tokens=P10_NEW, num_beams=4, eos_id=10,
                          length_penalty=0.6).cpu().numpy()
        log(f"10f beams: one beam equals greedy; 4 beams {beams.timing}; launches {launches}")
        require(np.array_equal(beams.tokens, lib), "10f: cli.generate's beams differ from the library's")
        require(launches["K4"] > 0, f"10f: K4 not launched: {launches}")
        out["beams"] = {"timing": beams.timing, "launches": launches}
        # 10g: 4 ragged prompts: each row's window equals its solo greedy run.
        prompts_file = os.path.join(work, "prompts.txt")
        with open(prompts_file, "w") as f:
            f.write("\n".join(P10_PROMPTS) + "\n")
        zero("K1", "K4")
        ragged = gen_cli.run(gen_argv + ["--prompts_file", prompts_file, "--greedy", "--time"])
        launches = read("K1", "K4")
        for text, window in zip(P10_PROMPTS, ragged.windows()):
            solo = generate(model, torch.tensor([list(text.encode())], device="cuda"),
                            max_new_tokens=P10_NEW, temperature=0.0)[0].cpu().numpy()
            require(np.array_equal(window, solo), f"10g: ragged row {text!r} differs from its "
                                                  "solo run")
        log(f"10g ragged: {len(P10_PROMPTS)} rows equal their solo greedy runs; "
            f"{ragged.timing}; launches {launches}")
        require(launches["K1"] > 0 and launches["K4"] > 0, f"10g: kernel not launched: {launches}")
        out["ragged"] = {"timing": ragged.timing, "launches": launches}
        # 10h: int8 weights: the share of new tokens equal to the fp stream's.
        quant = gen_cli.run(gen_argv + ["--prompt", P10_PROMPT, "--greedy", "--quantize", "int8"])
        p_len = prompt.shape[1]
        share = float((quant.tokens[0, p_len:] == want[0, p_len:]).mean())
        log(f"10h int8: {100 * share:.1f}% of {P10_NEW} new tokens equal the fp stream's "
            "(reported, no bar)")
        out["int8_token_match"] = share
        # 10i: serve_lm --model_dir --selftest: the engine on restored weights.
        zero("K1", "K4")
        rc = serve_lm.main(P10_MODEL + ["--device", "cuda", "--model_dir", a_dir, "--selftest",
                                        "--num_requests", "8"])
        launches = read("K1", "K4")
        log(f"10i serve_lm --model_dir --selftest: rc {rc}; launches {launches}")
        require(rc == 0, f"10i: serve_lm --selftest exited {rc}")
        require(launches["K4"] > 0, f"10i: K4 not launched: {launches}")
        out["serve_launches"] = launches
        log(f"phase 10 numbers [{card}]: checkpoint {nbytes} bytes, save {save_s:.3f}s, hash "
            f"{hash_s:.3f}s, verified restore {restore_s:.3f}s; decode "
            f"{greedy.timing['decode_tokens_per_s']:.1f} tokens/s greedy, "
            f"{beams.timing['positions_per_s']:.1f} positions/s with 4 beams")
        if then is not None:
            out["then"] = then(a_dir)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


# -- phase 11 ----------------------------------------------------------------
def prefix_trace(vocab: int, seed: int) -> list[dict]:
    """Phase 11a's trace: 12 requests in 3 groups, each group sharing a
    256-token prefix (16 whole blocks), tails of 16-200 tokens, Poisson
    50/s, groups interleaved. Four tails start with the first 5-40 tokens of
    an earlier tail of their group and then diverge, most of them mid-block;
    the last 2 requests repeat whole earlier prompts."""
    import numpy as np

    rng = np.random.default_rng(seed + 11)
    prefixes = [rng.integers(1, vocab, size=256) for _ in range(3)]
    tails: list = []
    # (group, tokens shared with tail k, fresh tokens)
    plan = [(0, None, 16), (1, None, 40), (2, None, 72), (0, (0, 8), 12), (1, None, 200),
            (2, (2, 40), 30), (0, None, 120), (1, (1, 5), 100), (2, None, 56),
            (0, (6, 24), 64)]
    prompts = []
    for group, shared, fresh in plan:
        tail = rng.integers(1, vocab, size=fresh)
        if shared is not None:
            tail = np.concatenate([tails[shared[0]][:shared[1]], tail])
        tails.append(tail)
        prompts.append(np.concatenate([prefixes[group], tail]).astype(np.int32))
    prompts += [prompts[1].copy(), prompts[4].copy()]
    entries, t = [], 0.0
    for p in prompts:
        t += float(rng.exponential(1.0 / 50.0))
        entries.append({"arrival": t, "max_new": SERVE_NEW, "prompt": p})
    return entries


def streams_equal(model, reqs, expects, label: str) -> None:
    """Every request finished with its expected stream; at a divergence,
    the model's top-2 logit gap there is printed."""
    from deeplearning_mpi_tpu_torch.cli.serve_lm import first_divergence
    from deeplearning_mpi_tpu_torch.serving import RequestState

    bad = [(r.rid, r.state.value, r.shed_reason) for r in reqs
           if r.state is not RequestState.FINISHED]
    require(not bad, f"{label}: requests not finished: {bad}")
    mismatched = [r for r, expect in zip(reqs, expects) if r.generated != expect]
    for r, expect in zip(reqs, expects):
        if r.generated != expect:
            log(f"{label}: rid {r.rid} diverges at "
                f"{first_divergence(model, r.prompt, r.generated, expect)}")
    require(not mismatched, f"{label}: {len(mismatched)}/{len(reqs)} streams differ")


#: Phase 11's depth: 4 of the 110M model's 12 blocks (its widths, vocab
#: and engine are phase 5's). The phase is host-bound eager serving and
#: two profiled replays, whose time grows with the blocks; its bars hold
#: at any depth.
P11_LAYERS = 4


def engine_features(torch, seed: int, card: str) -> dict:
    """Phase 11a, b and d on the 110M widths at ``P11_LAYERS`` blocks (f32,
    phase 5's seed and engine): the prefix cache, speculative decoding and
    warmup."""
    from deeplearning_mpi_tpu_torch.cli.serve_lm import latency_report, offline_greedy, replay
    from deeplearning_mpi_tpu_torch.models.transformer import (
        TransformerConfig,
        TransformerLM,
        self_draft,
    )
    from deeplearning_mpi_tpu_torch.ops.kernels.flash_decode import flash_decode_cuda
    from deeplearning_mpi_tpu_torch.serving import EngineConfig, ServingEngine

    cfg = TransformerConfig(num_layers=P11_LAYERS)
    model = TransformerLM(cfg, dtype=torch.float32, device="cuda").init_weights(seed)
    out: dict = {"card": card}

    def k4_run(engine, entries):
        torch.cuda.synchronize()
        flash_decode_cuda.launches = 0
        reqs, wall_s = replay(engine, entries)
        torch.cuda.synchronize()
        return reqs, wall_s, flash_decode_cuda.launches

    # 11a: the prefix cache.
    t0 = time.perf_counter()
    entries = prefix_trace(cfg.vocab_size, seed)
    engine = ServingEngine(model, EngineConfig(**SERVE_ENGINE, prefix_cache=True))
    reqs, wall_s, k4 = k4_run(engine, entries)
    expects = [offline_greedy(model, e["prompt"], e["max_new"], None) for e in entries]
    streams_equal(model, reqs, expects, "11a prefix cache")
    c = engine.counters
    cache, pool = engine.prefix_cache, engine.pool
    pool.check()
    held = pool.in_use
    require(held == len(cache.referenced_blocks()),
            f"11a: {held} blocks in use at drain, the cache references "
            f"{len(cache.referenced_blocks())}")
    cache.flush()
    require(pool.in_use == 0 and pool.total_allocated == pool.total_freed,
            f"11a: books do not balance after the flush: {pool.in_use} in use, "
            f"{pool.total_allocated} allocated, {pool.total_freed} freed")
    prefix = {k: c[k] for k in c if k.startswith("serve_prefix")}
    prefix.update(tokens_prefilled=sum(e["prompt"].size for e in entries)
                  - c["serve_prefix_tokens_reused_total"], k4_launches=k4,
                  latency=latency_report(reqs, wall_s), blocks_cached_at_drain=held)
    log(f"11a prefix cache: {len(reqs)} streams equal offline greedy; {json.dumps(prefix)}; "
        f"books balance after the flush | {time.perf_counter() - t0:.1f}s")
    require(c["serve_prefix_tokens_reused_total"] > 0, "11a: no token reused")
    require(c["serve_prefix_cow_copies_total"] > 0, "11a: no copy-on-write copy")
    out["prefix"] = prefix

    # The phase-5 trace's oracle, with the target's own K4 launches.
    entries = serve_trace(cfg.vocab_size, seed)
    flash_decode_cuda.launches = 0
    expects = [offline_greedy(model, e["prompt"], e["max_new"], None) for e in entries]
    torch.cuda.synchronize()
    target_k4 = flash_decode_cuda.launches
    require(target_k4 > 0, "11b: the target's offline decode did not launch K4")

    # 11b: speculative decoding, a 2-layer and a whole-model self-draft.
    t0 = time.perf_counter()
    spec = {"target_offline_k4_launches": target_k4}
    for layers in (2, cfg.num_layers):
        engine = ServingEngine(model, EngineConfig(**SERVE_ENGINE, spec_k=4),
                               draft=self_draft(model, layers))
        reqs, wall_s, k4 = k4_run(engine, entries)
        streams_equal(model, reqs, expects, f"11b speculative, {layers}-layer draft")
        c = engine.counters
        prop, acc, rb = (c[f"spec_{k}_total"] for k in ("proposed", "accepted", "rollback"))
        decode_tokens = c["serve_tokens_generated"] - len(reqs)
        row = {"proposed": prop, "accepted": acc, "rolled_back": rb,
               "acceptance": acc / prop if prop else None,
               "verify_steps": c["spec_verify_steps"], "draft_steps": c["spec_draft_steps"],
               "tokens_per_verify_step": decode_tokens / c["spec_verify_steps"],
               "k4_launches": k4, "latency": latency_report(reqs, wall_s)}
        log(f"11b speculative, {layers}-layer draft, spec_k 4: {json.dumps(row)}")
        require(prop > 0 and prop == acc + rb, f"11b: counters do not reconcile: {row}")
        require(k4 == c["spec_draft_steps"] * layers,
                f"11b: {k4} K4 launches, not one a draft layer a draft step")
        if layers == cfg.num_layers:
            require(rb == 0 and acc == prop, f"11b: a full self-draft rolled back: {row}")
        spec[f"draft_{layers}"] = row
    log(f"11b speculative OK in {time.perf_counter() - t0:.1f}s; the target's offline decode "
        f"launched K4 {target_k4} times")
    out["speculative"] = spec

    # 11d: warmup by CUDA-graph capture against the eager engine, in turns
    # (a drained engine serves the trace again).
    t0 = time.perf_counter()
    engines = {}
    for name in ("unwarmed", "warmed"):
        engines[name] = ServingEngine(model, EngineConfig(**SERVE_ENGINE))
    t_warm = time.perf_counter()
    built = engines["warmed"].warmup()
    warm: dict = {"unwarmed": [], "warmed": [], "built": built,
                  "warmup_s": time.perf_counter() - t_warm}
    log(f"11d warmup: {engines['warmed'].captures} CUDA graphs {built} in "
        f"{warm['warmup_s']:.2f}s")
    for name in ("unwarmed", "warmed", "warmed", "unwarmed"):
        engine = engines[name]
        captures, steps = engine.captures, engine.decode_steps
        reqs, wall_s, k4 = k4_run(engine, entries)
        streams_equal(model, reqs, expects, f"11d {name}")
        require(engine.captures == captures, "11d: traffic captured a program after warmup")
        steps = engine.decode_steps - steps
        require(k4 == steps * cfg.num_layers, f"11d: {k4} K4 launches for {steps} decode steps")
        rep = latency_report(reqs, wall_s)
        rep.update(captures=engine.captures, k4_launches=k4, decode_steps=steps)
        warm[name].append(rep)
        log(f"11d {name}: {json.dumps(rep)} [{card}]")
    for name in ("unwarmed", "warmed"):
        warm[f"profile_{name}"] = device_profile(
            torch, lambda: replay(engines[name], entries), f"11d profile {name}")
    log(f"11d warmup OK in {time.perf_counter() - t0:.1f}s")
    out["warmup"] = warm
    return out


def int8_serve(torch, model_dir: str) -> dict:
    """Phase 11c: ``cli.serve_lm --model_dir <phase 10's checkpoint>
    --kv_dtype int8 --selftest`` (the CLI's own trace and engine) at the
    reference's 0.9 acceptance gate, K4 launched on int8 pages."""
    from deeplearning_mpi_tpu_torch.cli import serve_lm
    from deeplearning_mpi_tpu_torch.ops.kernels.flash_decode import flash_decode_cuda

    t0 = time.perf_counter()
    flash_decode_cuda.launches = flash_decode_cuda.int8_launches = 0
    rc = serve_lm.main(P10_MODEL + ["--device", "cuda", "--model_dir", model_dir, "--selftest",
                                    "--kv_dtype", "int8"])
    torch.cuda.synchronize()
    launches = {"K4": flash_decode_cuda.launches, "K4_int8": flash_decode_cuda.int8_launches}
    log(f"11c serve_lm --kv_dtype int8 --selftest: rc {rc}; launches {launches} (the int8 "
        f"ones the engine's, the rest its offline oracle's) | {time.perf_counter() - t0:.1f}s")
    require(rc == 0, f"11c: serve_lm --kv_dtype int8 --selftest exited {rc}")
    require(launches["K4_int8"] > 0, f"11c: K4 not launched on int8 pages: {launches}")
    return {"rc": rc, "launches": launches}


def time_k4_int8(torch, gen, launches: int, fills, k4_len) -> dict:
    """K4 on int8 K/V (the engine's scheme) at phase 6's serving decode
    shape, L2-cold over 8 buffer sets, beside its plain version; no single
    PyTorch call takes int8 pages with scales, so no library time."""
    from deeplearning_mpi_tpu_torch.ops.kernels import flash_decode as fd
    from deeplearning_mpi_tpu_torch.ops.quant import quantize_kv

    B, H, D = len(fills), 12, 64
    q = torch.randn(B, 1, H, D, generator=gen, device="cuda")
    bufs = []
    for _ in range(8):
        (k, ks), (v, vs) = (quantize_kv(torch.randn(B, k4_len, H, D, generator=gen,
                                                    device="cuda")) for _ in range(2))
        bufs.append((k, v, ks, vs))
    index = torch.tensor(fills, dtype=torch.int32, device="cuda")
    filled = sum(f + 1 for f in fills)
    nbytes = 2 * filled * H * (D + 4) + 2 * B * H * D * 4
    flops = 4 * filled * H * D

    def cold(fn):
        turn = itertools.cycle(bufs)
        return time_ms(lambda: fn(*next(turn)))

    k, v, ks, vs = bufs[0]
    row = {
        "name": "K4 flash_decode (int8 K/V)", "route": "cuda",
        "source": "deeplearning_mpi_tpu_torch/csrc/flash_decode.cu",
        "replaces": "deeplearning_mpi_tpu/ops/pallas/flash_decode.py:100",
        "launches": launches,
        "max_abs_err": max_err(fd.flash_decode_cuda(q, k, v, index, k_scale=ks, v_scale=vs),
                               fd.flash_decode_reference(q, k, v, index, k_scale=ks,
                                                         v_scale=vs)),
        "ms": cold(lambda k, v, ks, vs: fd.flash_decode_cuda(q, k, v, index, k_scale=ks,
                                                             v_scale=vs)),
        "plain_ms": cold(lambda k, v, ks, vs: fd.flash_decode_reference(
            q, k, v, index, k_scale=ks, v_scale=vs)),
        "bound_ms": max(flops / PEAK_FLOPS["float32"], nbytes / PEAK_BYTES) * 1e3,
        "bound_by": "operations" if flops / PEAK_FLOPS["float32"] > nbytes / PEAK_BYTES else "bytes",
        "library_ms": None,
        "shape": f"B{B} L{k4_len} H{H} Hkv{H} D{D} float32 q, int8 K/V, fills {fills}, L2-cold",
    }
    log(f"time {row['name']} [{row['shape']}]: kernel {row['ms']:.4f} ms, plain "
        f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']}), "
        f"{launches} int8 launches in 11c")
    return row


# -- phase 12 ----------------------------------------------------------------
#: Phase 12's workloads: the JAX CLIs' flags at the reference's widths and
#: per-process batches, synthetic data, 2 epochs each.
P12_RESNET = ["--synthetic", "--arch", "resnet18", "--stem", "imagenet", "--batch_size", "128",
              "--learning_rate", "0.1", "--train_samples", "2048", "--num_epochs", "2"]
P12_UNET = ["--synthetic", "--image_size", "256", "--batch_size", "16", "--learning_rate", "1e-4",
            "--train_samples", "160", "--num_epochs", "2", "--loss", "bce"]


def _as_float64(model):
    """A float64 copy of a CNN of the port (each layer computes in its
    ``dtype``)."""
    import copy

    import torch

    model = copy.deepcopy(model).double()
    for m in model.modules():
        if hasattr(m, "dtype"):
            m.dtype = torch.float64
    return model


def _card_vs_cpu(torch, task: str, run, batch_rows: int, dtypes=("float32",)) -> dict:
    """Step-1 loss and every parameter gradient of the card's model (train
    mode, BatchNorm over the live NCCL group) against a copy on the CPU, on
    the same weights and the first ``batch_rows`` rows of the first batch,
    in each of ``dtypes`` (TF32 off): relative errors."""
    import copy

    from deeplearning_mpi_tpu_torch.models.norm import set_group
    from deeplearning_mpi_tpu_torch.train.trainer import _INPUTS, _loss_fn

    batch = next(iter(run.train_loader.epoch(0)))
    batch = {k: v[:batch_rows] for k, v in batch.items()}
    loss_fn = _loss_fn(task)
    names = [n for n, _ in run.trainer.state.model.named_parameters()]
    report = {"rows": batch_rows}
    for dtype in dtypes:
        out = {}
        for dev in ("cuda", "cpu"):
            model = run.trainer.state.model
            model = (copy.deepcopy(model) if dtype == "float32" else _as_float64(model)).to(dev)
            model.train()
            set_group(model, run.trainer.group if dev == "cuda" else None)
            b = {k: v.to(dev) for k, v in batch.items()}
            x = b[_INPUTS[task]].to(getattr(torch, dtype))
            loss = loss_fn(model(x), b)
            grads = torch.autograd.grad(loss, list(model.parameters()))
            out[dev] = (loss.detach().double().cpu(), [g.detach().double().cpu() for g in grads])
        rel = {n: float((a - b).norm() / b.norm().clamp(min=1e-30))
               for n, a, b in zip(names, out["cuda"][1], out["cpu"][1])}
        worst = max(rel, key=rel.get)
        report[dtype] = {
            "loss_card": float(out["cuda"][0]), "loss_cpu": float(out["cpu"][0]),
            "loss_rel": float((out["cuda"][0] - out["cpu"][0]).abs() / out["cpu"][0].abs()),
            "worst_grad": worst, "worst_grad_rel": rel[worst],
            "median_grad_rel": sorted(rel.values())[len(rel) // 2], "tensors": len(rel)}
    return report


def train_workload(torch, card: str, cli, flags: list[str], *, task: str, dtype: str,
                   flops_per_step: float, rdzv: str, model_dir: str | None, check_rows: int,
                   metric: str, grad_bar_dtype: str = "float32", label: str | None = None) -> dict:
    """One of 12b / 12c: the CLI's run built over NCCL at world size 1,
    every step timed (synchronised), the gradient mean counted, one step
    profiled; the bars of phase 12. The card-vs-CPU step holds the loss in
    float32 and the gradients in ``grad_bar_dtype`` to 1e-4 (relative);
    float32 gradients are reported either way."""
    import numpy as np

    from deeplearning_mpi_tpu_torch.resilience import tree_digests
    from deeplearning_mpi_tpu_torch.runtime import collectives
    from deeplearning_mpi_tpu_torch.utils import config

    argv = flags + ["--device", "cuda", "--dtype", dtype, "--coordinator", f"file://{rdzv}",
                    "--num_processes", "1", "--process_id", "0"]
    if model_dir is not None:
        argv += ["--model_dir", model_dir]
    run = cli.build(argv)
    label = label or f"12{'b' if task == 'classification' else 'c'} {cli.__name__.split('.')[-1]}"
    label = f"{label} {dtype}"
    out = {"dtype": dtype, "card": card}
    if dtype == "float32":
        dtypes = tuple(dict.fromkeys(("float32", grad_bar_dtype)))
        out["card_vs_cpu"] = check = _card_vs_cpu(torch, task, run, check_rows, dtypes)
        for dt in dtypes:
            c = check[dt]
            bar = "tol 1e-4" if dt == grad_bar_dtype else "reported, no bar"
            log(f"{label}: card vs CPU step 1 (B{check_rows}, {dt}, TF32 off): loss "
                f"{c['loss_card']:.8f} / {c['loss_cpu']:.8f} (rel {c['loss_rel']:.2e}); gradients "
                f"relative L2 max {c['worst_grad_rel']:.2e} ({c['worst_grad']}), median "
                f"{c['median_grad_rel']:.2e} over {c['tensors']} tensors ({bar})")
        require(check["float32"]["loss_rel"] <= 1e-4,
                f"{label}: the card's step-1 loss differs from the CPU's: {check}")
        require(check[grad_bar_dtype]["worst_grad_rel"] <= 1e-4,
                f"{label}: the card's {grad_bar_dtype} gradients differ from the CPU's: {check}")
    trainer = run.trainer
    inner = trainer.train_step
    times, losses = [], []

    def timed(state, batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = inner(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
        return state, metrics

    trainer.train_step = timed
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()  # what earlier phases still hold
    collectives.counts.clear()
    t0 = time.perf_counter()
    config.execute(run)
    wall = time.perf_counter() - t0
    grad_means = collectives.counts["all_reduce_mean"]
    peak = torch.cuda.max_memory_allocated() - base
    steps = len(times)
    step_s = sorted(times[2:])[len(times[2:]) // 2]
    batch = run.train_loader.batch_size
    ev = trainer.history[-1]
    out.update({"losses": losses, "step_times_s": times, "step_s_median": step_s,
                "images_per_s": batch / step_s, "model_flops_per_step": flops_per_step,
                "mfu": flops_per_step / step_s / PEAK_FLOPS[dtype], "peak_memory_above_start": peak,
                "grad_all_reduce_calls": grad_means, "steps": steps, "wall_s": wall,
                "eval": {k: v for k, v in ev.items() if k.startswith("eval_")}})
    log(f"{label} [{card}]: losses {[round(x, 4) for x in losses]}")
    log(f"{label} [{card}]: step median {1e3 * step_s:.2f} ms (steps 3-{steps}), "
        f"{out['images_per_s']:.1f} images/s, MFU {100 * out['mfu']:.3f}% of "
        f"{PEAK_FLOPS[dtype] / 1e12:.0f} TFLOP/s ({flops_per_step:.4e} model FLOPs a step), "
        f"peak memory {peak / 2**30:.2f} GiB above the start, eval {metric} "
        f"{ev.get('eval_' + metric, float('nan')):.4f}, {grad_means} gradient all-reduces in "
        f"{steps} steps")
    require(all(np.isfinite(losses)), f"{label}: non-finite loss {losses}")
    require(sum(losses[-3:]) / 3 < losses[0], f"{label}: loss did not fall: {losses}")
    require(grad_means == steps, f"{label}: {grad_means} gradient all-reduces in {steps} steps")
    require(("eval_" + metric) in ev, f"{label}: no eval {metric} in {ev}")
    out["final_digests"] = tree_digests(trainer.state.arrays())
    last = next(iter(run.train_loader.epoch(0)))
    out["profile"] = device_profile(torch, lambda: inner(trainer.state, last),
                                    f"{label} [{card}] profile (one step)")
    out["run"] = run
    return out


def original_workloads(torch, card: str) -> dict:
    """Phase 12: hello_world over NCCL, ResNet-18 and the UNet trained through
    their CLIs over NCCL at world size 1 (f32, then bf16), and the ResNet's
    checkpoint restored verified and evaluated again (12a-12d)."""
    import shutil
    import tempfile

    from deeplearning_mpi_tpu_torch.cli import hello_world, train_resnet, train_unet
    from deeplearning_mpi_tpu_torch.resilience import tree_digests
    from deeplearning_mpi_tpu_torch.runtime import bootstrap
    from deeplearning_mpi_tpu_torch.train import create_train_state
    from deeplearning_mpi_tpu_torch.train.checkpoint import Checkpointer

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="phase12-", dir=os.path.join(ROOT, "build"))
    out: dict = {"card": card}
    try:
        # 12a: the transport checks over NCCL, world size 1.
        t0 = time.perf_counter()
        res = hello_world.run(["--device", "cuda", "--coordinator",
                               f"file://{os.path.join(work, 'hello')}", "--num_processes", "1",
                               "--process_id", "0"])
        log(f"12a hello_world over NCCL: {res} in {time.perf_counter() - t0:.1f}s")
        require(res.ok, f"12a: hello_world failed: {res}")
        out["hello_world"] = {"ok": res.ok, "n_devices": res.n_devices}

        model_dir = os.path.join(work, "resnet")
        from deeplearning_mpi_tpu_torch.telemetry.flops import (
            resnet_train_flops,
            unet_train_flops,
        )

        rn_flops = resnet_train_flops("resnet18", 128, 32, stem="imagenet")
        un_flops = unet_train_flops(16, 256, in_channels=3, out_channels=1)
        for dtype in ("float32", "bfloat16"):
            r = train_workload(torch, card, train_resnet, P12_RESNET, task="classification",
                               dtype=dtype, flops_per_step=rn_flops,
                               rdzv=os.path.join(work, f"rn-{dtype}"),
                               model_dir=model_dir if dtype == "float32" else None,
                               check_rows=8, metric="accuracy")
            run = r.pop("run")
            if dtype == "float32":
                # 23c: 12b's input pipeline, the native C++ transforms and
                # the loader's default fetch threads.
                from deeplearning_mpi_tpu_torch.data.native import (
                    native_available,
                    pipeline_description,
                )

                r["pipeline"] = pipeline_description(run.train_loader.num_workers)
                log(f"23c 12b [{card}]: {r['pipeline']}; {r['images_per_s']:.1f} images/s, "
                    f"busy share {100 * r['profile']['busy_share']:.2f}% (one profiled step), "
                    "12b's bars held above")
                require(native_available() and run.train_loader.num_workers > 0,
                        f"23c: 12b did not run the native pipeline: {r['pipeline']}")
            if dtype != "float32":
                r.pop("final_digests")
            if dtype == "float32":
                # 12d: save, verified restore, --eval_only.
                n_params = sum(p.numel() for p in run.trainer.state.model.parameters())
                require(n_params == 11_181_642, f"12b: ResNet-18 has {n_params} parameters")
                ck = Checkpointer(os.path.join(model_dir, "resnet_distributed"))
                template = create_train_state(
                    train_resnet.build_model(run.args, "cuda"), run.trainer.state.tx)
                restored, epoch = ck.restore_verified(template)
                same = tree_digests(restored.arrays()) == r.pop("final_digests")
                ev = train_resnet.train(
                    P12_RESNET + ["--device", "cuda", "--model_dir", model_dir, "--eval_only",
                                  "--coordinator", f"file://{os.path.join(work, 'eval')}",
                                  "--num_processes", "1", "--process_id", "0"]).history[-1]
                want = r["eval"]["eval_accuracy"]
                log(f"12d checkpoint: restored verified epoch {epoch}, tree_digests equal "
                    f"(batch_stats included: {'batch_stats' in restored.arrays()}): {same}; "
                    f"--eval_only accuracy {ev['accuracy']:.4f} against the last eval's "
                    f"{want:.4f}")
                require(same and "batch_stats" in restored.arrays(),
                        "12d: the restored state's digests differ from the trained state's")
                require(ev["accuracy"] == want, f"12d: --eval_only accuracy {ev['accuracy']} "
                        f"!= the last eval's {want}")
                out["checkpoint"] = {"epoch": epoch, "digests_equal": same,
                                     "eval_only_accuracy": ev["accuracy"],
                                     "last_eval_accuracy": want}
            bootstrap.shutdown()
            out[f"resnet18_{dtype}"] = r
        for dtype in ("float32", "bfloat16"):
            u = train_workload(torch, card, train_unet, P12_UNET, task="segmentation",
                               dtype=dtype, flops_per_step=un_flops,
                               rdzv=os.path.join(work, f"un-{dtype}"), model_dir=None,
                               check_rows=4, metric="dice", grad_bar_dtype="float64")
            u.pop("run")
            u.pop("final_digests")
            bootstrap.shutdown()
            out[f"unet_{dtype}"] = u
    finally:
        bootstrap.shutdown()
        shutil.rmtree(work, ignore_errors=True)
    return out


# -- phase 13 ----------------------------------------------------------------
#: Phase 13's model flags: the 110M widths (phase 10's) with 8 routed experts,
#: top 2, in every block (capacity factor 1.25, token choice: the defaults).
P13_MODEL = P10_MODEL + ["--moe_experts", "8", "--moe_top_k", "2"]
#: Its CLI training: phase 10's shape (seq 2048, batch 8, flash in bf16, 24
#: sequences: 2 steps an epoch).
P13_TRAIN = P13_MODEL + ["--device", "cuda", "--attention", "flash", "--dtype", "bfloat16",
                         "--seq_len", "2048", "--batch_size", "8", "--train_sequences", "24",
                         "--num_epochs", "1"]
P13_NEW = 32
MOE_AUX_WEIGHT = 0.01
#: 13c's depth: the CLIs train, checkpoint, restore and generate with 4 of
#: the 12 blocks (every width kept), which 13a and 13b run whole.
P13C_LAYERS = ["--num_layers", "4"]


def moe_config(**kw):
    """``TransformerConfig()`` with 8 experts, top 2, capacity factor 1.25,
    token choice."""
    from deeplearning_mpi_tpu_torch.models.transformer import TransformerConfig

    return TransformerConfig(moe_experts=8, moe_top_k=2, moe_capacity_factor=1.25, **kw)


def moe_train(torch, seed: int) -> dict:
    """13a: the MoE LM at full width and depth, bf16, flash attention, B8
    S2048, Adam 3e-4 with clip 1.0, ``aux_weight`` 0.01: 6 steps (3 epochs
    of 2 batches of 16 seeded sequences) through ``make_train_step``."""
    import numpy as np

    from deeplearning_mpi_tpu_torch.data import Loader, SyntheticTokens
    from deeplearning_mpi_tpu_torch.models.transformer import TransformerLM
    from deeplearning_mpi_tpu_torch.ops.kernels import flash_attention as fa
    from deeplearning_mpi_tpu_torch.telemetry.flops import transformer_train_flops
    from deeplearning_mpi_tpu_torch.train import (
        build_optimizer,
        create_train_state,
        make_train_step,
    )

    cfg = moe_config()
    B, S, steps = 8, 2048, 6
    model = TransformerLM(cfg, dtype=torch.bfloat16, device="cuda").init_weights(seed)
    n_params = sum(p.numel() for p in model.parameters())
    loader = Loader(SyntheticTokens(2 * B, S, vocab_size=cfg.vocab_size, seed=seed), B,
                    shuffle=True, seed=seed, device="cuda")
    batches = [b for epoch in range(steps // 2) for b in loader.epoch(epoch)]
    state = create_train_state(model, build_optimizer("adam", 3e-4, clip_norm=1.0),
                               attention_fn=fa.flash_attention_bhsd)
    step = make_train_step("lm", aux_weight=MOE_AUX_WEIGHT)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels = {"K1": fa.flash_attention_cuda, "K2": fa.flash_attention_bwd_dq_cuda,
               "K3": fa.flash_attention_bwd_dkv_cuda}
    for fn in kernels.values():
        fn.launches = 0
    losses, aux, drop, times = [], [], [], []
    for batch in batches:
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
        aux.append(float(metrics["moe_aux_loss"]))
        drop.append(float(metrics["moe_dropped_frac"]))
    launches = {k: fn.launches for k, fn in kernels.items()}
    peak = torch.cuda.max_memory_allocated()
    step_s = sorted(times[2:])[len(times[2:]) // 2]
    flops = transformer_train_flops(cfg, B, S)
    result = {"params": n_params, "losses": losses, "aux": aux, "dropped_frac": drop,
              "step_times_s": times, "step_s_median": step_s, "tokens_per_s": B * S / step_s,
              "model_flops_per_step": flops, "mfu": flops / step_s / PEAK_FLOPS["bfloat16"],
              "max_memory_allocated": peak, "launches": launches}
    log(f"13a moe train: {n_params} params, losses {[round(x, 4) for x in losses]}, aux "
        f"{[round(x, 4) for x in aux]}, moe_dropped_frac {[round(x, 4) for x in drop]}")
    log(f"13a moe train: step median {1e3 * step_s:.2f} ms (steps 3-6), "
        f"{result['tokens_per_s']:.0f} tokens/s, MFU {100 * result['mfu']:.2f}% of 989 TFLOP/s "
        f"({flops:.4e} model FLOPs a step: router and the 2 active experts), "
        f"max_memory_allocated {peak / 2**30:.2f} GiB, launches {launches}")
    require(all(np.isfinite(losses)), f"13a: non-finite loss {losses}")
    require(sum(losses[-3:]) / 3 < losses[0], f"13a: loss did not fall: {losses}")
    require(all(np.isfinite(a) and a > 0 for a in aux), f"13a: balance loss {aux}")
    require(len(drop) == steps and all(0.0 <= d <= 1.0 for d in drop),
            f"13a: moe_dropped_frac {drop}")
    require(all(n == 12 * steps for n in launches.values()),
            f"13a: expected {12 * steps} launches of each kernel, got {launches}")
    result["profile"] = device_profile(
        torch, lambda: step(state, batches[-1]), "13a moe train profile (one step)")
    # The motifs route equal tokens alike; uniformly random tokens drop far
    # fewer claims. The dense dispatch's shapes are fixed by capacity, so
    # the step time should not move: two more steps on such a batch.
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rand = {"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device="cuda",
                                    dtype=batches[0]["tokens"].dtype)}
    rand_times, rand_drop = [], []
    for _ in range(2):
        t0 = time.perf_counter()
        state, metrics = step(state, rand)
        torch.cuda.synchronize()
        rand_times.append(time.perf_counter() - t0)
        rand_drop.append(float(metrics["moe_dropped_frac"]))
    result["random_tokens"] = {"dropped_frac": rand_drop, "step_times_s": rand_times}
    log(f"13a moe train, random tokens: moe_dropped_frac {[round(x, 4) for x in rand_drop]}, "
        f"second step {1e3 * rand_times[-1]:.2f} ms (motif median {1e3 * step_s:.2f} ms)")
    require(all(np.isfinite(rand_drop)), f"13a: random-token steps {rand_drop}")
    return result


def moe_card_vs_cpu(torch, seed: int) -> dict:
    """13b: the same widths at 2 layers, float32 (TF32 off), B1 S256, one
    seed's weights on the card and on the CPU: the routing (every layer's
    dispatch mask) equal, the step-1 loss within 1e-4 relative, every
    gradient (router and expert stacks included) within 1e-4 relative L2."""
    from deeplearning_mpi_tpu_torch.data import SyntheticTokens
    from deeplearning_mpi_tpu_torch.models import moe
    from deeplearning_mpi_tpu_torch.models.transformer import TransformerLM
    from deeplearning_mpi_tpu_torch.ops.kernels import flash_attention as fa
    from deeplearning_mpi_tpu_torch.ops.loss import lm_cross_entropy

    cfg = moe_config(num_layers=2)
    S = 256
    cpu = TransformerLM(cfg, dtype=torch.float32, device="cpu").init_weights(seed)
    card = TransformerLM(cfg, dtype=torch.float32, device="cuda")
    card.load_state_dict(cpu.state_dict())
    tokens = torch.from_numpy(SyntheticTokens(1, S, vocab_size=cfg.vocab_size,
                                              seed=seed)[0]["tokens"][None]).long()
    out = {}
    for name, model in (("cuda", card), ("cpu", cpu)):
        x = tokens.to(name)
        inputs = []
        hooks = [layer.mlp.register_forward_hook(lambda m, a, o: inputs.append(a[0].detach()))
                 for layer in model.layers]
        with moe.collecting(model) as sown:
            logits = model(x, attention_fn=fa.flash_attention_bhsd)
        for h in hooks:
            h.remove()
        loss = lm_cross_entropy(logits, x) + MOE_AUX_WEIGHT * moe.collect_aux_loss(sown)
        names, params = zip(*model.named_parameters())
        grads = torch.autograd.grad(loss, params)
        masks = []
        with torch.no_grad():
            for layer, h in zip(model.layers, inputs):
                probs = torch.softmax(layer.mlp.router(h.float()), dim=-1)
                combine = layer.mlp._token_choice([probs], layer.mlp.capacity(S))[0][0]
                masks.append((combine > 0).cpu())
        out[name] = (float(loss.detach()), {n: g.double().cpu() for n, g in zip(names, grads)},
                     masks)
    routing_equal = [bool(torch.equal(a, b)) for a, b in zip(out["cuda"][2], out["cpu"][2])]
    loss_rel = abs(out["cuda"][0] - out["cpu"][0]) / abs(out["cpu"][0])
    rel = {n: float((g - out["cpu"][1][n]).norm() / out["cpu"][1][n].norm().clamp(min=1e-30))
           for n, g in out["cuda"][1].items()}
    worst = max(rel, key=rel.get)
    first_bad = next((n for n in rel if rel[n] > 1e-4), None)
    report = {"routing_equal": routing_equal, "loss_card": out["cuda"][0],
              "loss_cpu": out["cpu"][0], "loss_rel": loss_rel, "worst_grad": worst,
              "worst_grad_rel": rel[worst], "median_grad_rel": sorted(rel.values())[len(rel) // 2],
              "tensors": len(rel), "first_over_bar": first_bad,
              "dispatch_slots": [int(m.sum()) for m in out["cpu"][2]]}
    log(f"13b card vs CPU (f32, TF32 off, 2 layers, B1 S{S}): routing equal per layer "
        f"{routing_equal} ({report['dispatch_slots']} slots taken), loss {out['cuda'][0]:.6f} "
        f"vs {out['cpu'][0]:.6f} (rel {loss_rel:.3e}), gradients rel L2 worst {rel[worst]:.3e} "
        f"({worst}), median {report['median_grad_rel']:.3e} over {len(rel)} tensors; first "
        f"over 1e-4: {first_bad}")
    require(all(routing_equal), f"13b: routing differs on the card: {routing_equal}")
    require(loss_rel <= 1e-4, f"13b: loss rel {loss_rel}")
    require(first_bad is None, f"13b: gradients differ from layer {first_bad} on: "
            f"{rel[first_bad] if first_bad else 0}")
    return report


def moe_clis(torch, card: str) -> dict:
    """13c: the MoE CLIs at the 110M widths in a temporary directory under
    ``build/``; 13d: ``--ep 1`` over NCCL at world size 1 (the wiring only:
    one card cannot hold two expert ranks)."""
    import contextlib
    import io
    import shutil
    import tempfile

    from deeplearning_mpi_tpu_torch.cli import generate as gen_cli
    from deeplearning_mpi_tpu_torch.cli import serve_lm, train_lm
    from deeplearning_mpi_tpu_torch.models.generate import generate
    from deeplearning_mpi_tpu_torch.ops.kernels import flash_attention as fa
    from deeplearning_mpi_tpu_torch.ops.kernels import flash_decode as fd
    from deeplearning_mpi_tpu_torch.runtime import bootstrap
    from deeplearning_mpi_tpu_torch.utils.config import restore_lm

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="phase13-", dir=os.path.join(ROOT, "build"))
    out: dict = {"card": card}

    def cli(main, argv):
        buf, err = io.StringIO(), io.StringIO()
        try:
            with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(err):
                rc = main(argv)
        except SystemExit as e:
            rc = e.code
        for line in buf.getvalue().splitlines():
            log(f"  | {line}")
        return rc, buf.getvalue(), err.getvalue()

    try:
        model_dir = os.path.join(work, "moe")
        t0 = time.perf_counter()
        rc, text, err = cli(train_lm.main, P13_TRAIN + P13C_LAYERS + ["--model_dir", model_dir])
        log(f"13c train_lm --moe_experts 8 {' '.join(P13C_LAYERS)}: exit {rc} in "
            f"{time.perf_counter() - t0:.1f}s")
        require(rc == 0 and "moe_dropped_frac" in text, f"13c: train_lm exited {rc}: {err[-2000:]}")
        rc, _, err = cli(train_lm.main, P13_TRAIN + ["--moe_routing", "expert_choice"])
        log(f"13c --moe_routing expert_choice without --allow_acausal_routing: exit {rc}")
        require(rc == 2 and "--allow_acausal_routing" in err, f"13c: expert choice exited {rc}")
        t0 = time.perf_counter()
        # The routing flag's path at the same widths, 2 layers deep (the
        # 12-layer model trained just above).
        rc, text, err = cli(train_lm.main, P13_TRAIN + ["--moe_routing", "expert_choice",
                                                        "--allow_acausal_routing",
                                                        "--num_layers", "2"])
        log(f"13c expert choice with the acknowledgement: exit {rc} in "
            f"{time.perf_counter() - t0:.1f}s")
        require(rc == 0 and "moe_dropped_frac" in text, f"13c: expert choice exited {rc}: "
                f"{err[-2000:]}")

        for fn in (fa.flash_attention_cuda, fd.flash_decode_cuda):
            fn.launches = 0
        t0 = time.perf_counter()
        res = gen_cli.run(P13_MODEL + P13C_LAYERS + ["--device", "cuda", "--model_dir", model_dir,
                                       "--prompt", P10_PROMPT, "--max_new_tokens",
                                       str(P13_NEW), "--greedy"])
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        launches = {"K1": fa.flash_attention_cuda.launches, "K4": fd.flash_decode_cuda.launches}
        cfg = moe_config(vocab_size=256, num_layers=int(P13C_LAYERS[1]))
        model = restore_lm(cfg, dtype=torch.float32, device=torch.device("cuda"),
                           model_dir=model_dir)
        prompt = torch.tensor([list(P10_PROMPT.encode())], device="cuda")
        want = generate(model, prompt, max_new_tokens=P13_NEW, temperature=0.0).cpu().numpy()
        p_len = prompt.shape[1]
        expect_k4 = cfg.num_layers * (p_len + P13_NEW - 1)
        same = bool((res.tokens == want).all())
        log(f"13c generate --moe_experts 8 --greedy: {p_len}-token prompt + {P13_NEW} new in "
            f"{gen_s:.1f}s, token-identical to the library: {same}; launches {launches} "
            f"(K4 expected {expect_k4}: one a layer for each prompt position of the stepwise "
            f"prefill and each new token after the first; K1 none)")
        require(same, "13c: cli.generate differs from the library's generate")
        require(launches == {"K1": 0, "K4": expect_k4}, f"13c: launches {launches}")
        out["generate"] = {"tokens_equal": same, "launches": launches, "seconds": gen_s,
                           "prompt_len": p_len, "new": P13_NEW}
        rc, _, err = cli(serve_lm.main, P10_MODEL + ["--moe_experts", "8", "--device", "cuda",
                                                     "--model_dir", model_dir, "--selftest"])
        log(f"13c serve_lm --moe_experts 8: exit {rc}: {err.strip()}")
        require(rc == 1 and "dense-MLP only" in err, f"13c: serve_lm exited {rc}")

        # 13d: --ep over NCCL at world size 1 (2 layers at full width).
        t0 = time.perf_counter()
        ep = P13_TRAIN + ["--num_layers", "2", "--ep", "1", "--dp", "1", "--coordinator",
                          f"file://{os.path.join(work, 'ep-rdzv')}", "--num_processes", "1",
                          "--process_id", "0"]
        rc, text, err = cli(train_lm.main, ep)
        log(f"13d train_lm --ep 1 over NCCL at world size 1 (the wiring only: NCCL refuses "
            f"two expert ranks on one card): exit {rc} in {time.perf_counter() - t0:.1f}s")
        require(rc == 0 and "nccl" in text, f"13d: exited {rc}: {err[-2000:]}")
    finally:
        bootstrap.shutdown()
        shutil.rmtree(work, ignore_errors=True)
    return out


def moe_phase(torch, card: str, seed: int) -> dict:
    """Phase 13: the MoE LM (13a-13d)."""
    out = {"train": moe_train(torch, seed)}
    out["card_vs_cpu"] = moe_card_vs_cpu(torch, seed)
    out.update(moe_clis(torch, card))
    return out


# -- phase 14 ----------------------------------------------------------------
#: Phase 14's attention shape: bf16 B2 S8192 H12 D64 over a ring of 4
#: (S_l 2048), one card, the one-process form of the schedules.
P14_B, P14_S, P14_H, P14_D, P14_SP = 2, 8192, 12, 64, 4
#: 14a's cases: (name, dtype, kv heads, causal, window).
P14_CASES = [("bf16 causal", "bfloat16", 12, True, None),
             ("bf16 window512", "bfloat16", 12, True, 512),
             ("bf16 GQA Hkv4", "bfloat16", 4, True, None),
             ("bf16 full", "bfloat16", 12, False, None),
             ("f32 causal", "float32", 12, True, None)]


def _plain_flash_fn(torch):
    """An autograd Function over the plain versions of K1 (forward, with the
    lse) and K2/K3 (backward): Ulysses' inner, held against the kernels."""
    from deeplearning_mpi_tpu_torch.ops.kernels import flash_attention as fa

    class PlainFlash(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, causal, window):
            o, lse = fa.flash_attention_reference(q, k, v, causal=causal, window=window,
                                                  return_lse=True)
            ctx.save_for_backward(q, k, v, o, lse)
            ctx.kw = dict(causal=causal, window=window)
            return o

        @staticmethod
        def backward(ctx, do):
            q, k, v, o, lse = ctx.saved_tensors
            return (*fa.flash_attention_bwd_reference(q, k, v, o, do.to(o.dtype), lse, **ctx.kw),
                    None, None)

    return lambda q, k, v, causal=True, window=None: PlainFlash.apply(q, k, v, causal, window)


def _attention_and_grads(torch, fn, q, k, v, do):
    """``fn``'s output and ``(dq, dk, dv)`` for the output gradient ``do``."""
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    out = fn(*leaves)
    grads = torch.autograd.grad(out, leaves, do)
    return [out.detach(), *grads]


def _whole_sequence(torch, q, k, v, do, causal, window, grad_dtype):
    """One K1 call and one K2/K3 pair over the whole sequence, grouped K/V
    repeated and dK/dV group-summed back, with the schedule's rounding
    points: the ring's kernels give float32 gradients that are summed and
    then cast once (``grad_dtype`` float32); Ulysses' inner gives q's dtype
    a head, which its repeat's backward then sums (``grad_dtype`` None).
    Under GQA the second rounds each head's dK/dV before a sum that may
    cancel; the second value is then each of dK / dV's ``sum |term|`` over
    its group (:func:`terms_scale`), the size the elementwise bound is taken
    of (None where nothing is rounded before the group sum)."""
    from deeplearning_mpi_tpu_torch.ops.attention import repeat_kv
    from deeplearning_mpi_tpu_torch.ops.kernels import flash_attention as fa

    rep = q.shape[2] // k.shape[2]
    kr, vr = repeat_kv(k, rep), repeat_kv(v, rep)
    o, lse = fa.flash_attention(q, kr, vr, causal=causal, window=window, return_lse=True)
    grads = fa.flash_attention_bwd(q, kr, vr, o, do, lse, causal=causal, window=window,
                                   grad_dtype=grad_dtype)
    dq, dk, dv = (g.float().reshape(*g.shape[:2], -1, rep, g.shape[-1]).sum(3)
                  if i and rep > 1 else g for i, g in enumerate(grads))
    scales = ([terms_scale(g, rep) for g in grads[1:]] if rep > 1 and grad_dtype is None
              else None)
    return [o, dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)], scales


def seq_attention(torch, gen) -> dict:
    """14a: the one-process ring (kernel inner) and Ulysses over ``sp`` 4 at
    B2 S8192 H12 D64, each case's output and gradients held to
    ``FWD_TOL`` / ``GRAD_TOL`` against the same schedule on the plain
    versions of K1-K3 and against one K1 / K2+K3 call over the whole
    sequence; a second run bit-identical."""
    from deeplearning_mpi_tpu_torch.parallel import make_ring_attention_fn, make_ulysses_attention_fn
    from deeplearning_mpi_tpu_torch.parallel import ring_flash

    B, S, H, D, sp = P14_B, P14_S, P14_H, P14_D, P14_SP
    plain_inner = _plain_flash_fn(torch)
    schedules = {
        "ring": (make_ring_attention_fn(sp=sp), make_ring_attention_fn(sp=sp,
                                                                       kernels=ring_flash.PLAIN)),
        "ulysses": (make_ulysses_attention_fn(sp=sp),
                    make_ulysses_attention_fn(sp=sp, inner=plain_inner)),
    }
    out = {}
    for name, dtype_name, hkv, causal, window in P14_CASES:
        dtype = getattr(torch, dtype_name)
        q = torch.randn(B, S, H, D, generator=gen, device="cuda").to(dtype)
        k, v = (torch.randn(B, S, hkv, D, generator=gen, device="cuda").to(dtype)
                for _ in range(2))
        do = torch.randn(B, S, H, D, generator=gen, device="cuda").to(dtype)
        kw = {"causal": causal} | ({"window": window} if window else {})
        for sched, (kernel_fn, plain_fn) in schedules.items():
            if sched == "ulysses" and name not in ("bf16 causal", "bf16 GQA Hkv4"):
                continue
            whole, scales = _whole_sequence(torch, q, k, v, do, causal, window,
                                            torch.float32 if sched == "ring" else None)
            # dK / dV of grouped K/V: the bound is taken of each group's
            # sum of term magnitudes (both references sum the same terms).
            sizes = (None, None, *(scales or (None, None)))
            run = lambda fn: _attention_and_grads(torch, lambda *t: fn(*t, **kw), q, k, v, do)  # noqa: E731
            got, again = run(kernel_fn), run(kernel_fn)
            torch.cuda.synchronize()
            require(all(torch.equal(a, b) for a, b in zip(got, again)),
                    f"14a {sched} {name}: a second run differs")
            plain = run(plain_fn)
            errs = []
            for ref_name, ref in (("plain", plain), ("whole", whole)):
                for label, g, r, tol, size in zip(("out", "dq", "dk", "dv"), got, ref,
                                                  (FWD_TOL, GRAD_TOL, GRAD_TOL, GRAD_TOL), sizes):
                    atol, rtol, l2 = tol[dtype_name]
                    require(g.dtype == r.dtype and g.shape == r.shape,
                            f"14a {sched} {name}: {label} {g.dtype}{tuple(g.shape)} vs {ref_name} "
                            f"{r.dtype}{tuple(r.shape)}")
                    require(bool(torch.isfinite(g).all()), f"14a {sched} {name}: non-finite {label}")
                    ok, err, rel = grads_close(g, r, atol, rtol, l2, size)
                    errs.append({"vs": ref_name, "tensor": label, "max_abs_err": err, "rel_l2": rel})
                    require(ok, f"14a {sched} {name}: {label} vs {ref_name}: max abs err {err}, "
                            f"rel L2 {rel} (bound atol {atol:g} + rtol {rtol:g}, rel L2 {l2:g})")
            out[f"{sched} {name}"] = errs
            worst = {r: max(e["rel_l2"] for e in errs if e["vs"] == r) for r in ("plain", "whole")}
            log(f"14a {sched} sp {sp} {name} B{B} S{S} H{H} Hkv{hkv} D{D}: out, dq, dk, dv within "
                f"FWD_TOL / GRAD_TOL of the plain schedule (worst rel L2 {worst['plain']:.3e}) "
                f"and of one whole-sequence K1 / K2+K3 call ({worst['whole']:.3e}); "
                f"bit-identical on a second run")
            del got, again, plain, whole
    return out


def seq_train(torch, seed: int) -> dict:
    """14b: the 110M ``TransformerConfig()`` at B2 S8192, bf16, Adam 3e-4
    with clip 1.0, with the one-process ring over ``sp`` 4 as its attention
    fn, against the same weights with ``flash_attention_bhsd`` over the
    whole sequence: step-1 gradients, then 4 steps of each through
    ``make_train_step`` (launch counts, step times, memory, one profiled
    step each)."""
    import numpy as np

    from deeplearning_mpi_tpu_torch.data import SyntheticTokens
    from deeplearning_mpi_tpu_torch.models.transformer import TransformerConfig, TransformerLM
    from deeplearning_mpi_tpu_torch.ops.kernels import flash_attention as fa
    from deeplearning_mpi_tpu_torch.ops.loss import lm_cross_entropy
    from deeplearning_mpi_tpu_torch.parallel import make_ring_attention_fn
    from deeplearning_mpi_tpu_torch.train import build_optimizer, create_train_state, make_train_step

    cfg = TransformerConfig()
    B, S, steps = P14_B, P14_S, 4
    ds = SyntheticTokens(B * steps, S, vocab_size=cfg.vocab_size, seed=seed)
    rows = np.stack([ds[i]["tokens"] for i in range(B * steps)])
    batches = [{"tokens": torch.from_numpy(rows[i * B:(i + 1) * B]).cuda()} for i in range(steps)]
    fns = {"ring": make_ring_attention_fn(sp=P14_SP), "flash": fa.flash_attention_bhsd}
    kernels = {"K1": fa.flash_attention_cuda, "K2": fa.flash_attention_bwd_dq_cuda,
               "K3": fa.flash_attention_bwd_dkv_cuda}
    model = TransformerLM(cfg, dtype=torch.bfloat16, device="cuda").init_weights(seed)
    init = {n: p.detach().clone() for n, p in model.named_parameters()}

    def grads(attention_fn):
        model.zero_grad(set_to_none=True)
        tokens = batches[0]["tokens"]
        lm_cross_entropy(model(tokens, attention_fn=attention_fn), tokens).backward()
        return {n: p.grad.float().clone() for n, p in model.named_parameters()}

    g_ring, g_flash = grads(fns["ring"]), grads(fns["flash"])
    model.zero_grad(set_to_none=True)
    rel = {n: float((g_ring[n] - g_flash[n]).norm() / g_flash[n].norm().clamp(min=1e-30))
           for n in g_flash}
    worst = max(rel, key=rel.get)
    log(f"14b ring vs flash step-1 grads (B{B} S{S}, {len(rel)} tensors): relative L2 error max "
        f"{rel[worst]:.3e} ({worst}), median {sorted(rel.values())[len(rel) // 2]:.3e} (tol 5e-2)")
    require(rel[worst] <= 5e-2, f"14b: ring grads differ from flash: {worst} {rel[worst]}")
    del g_ring, g_flash
    result = {"grads_rel_l2_max": rel[worst], "grads_worst": worst}
    expect = {"ring": 12 * sum(range(1, P14_SP + 1)), "flash": 12}
    for name, fn in fns.items():
        with torch.no_grad():
            for n, p in model.named_parameters():
                p.copy_(init[n])
        state = create_train_state(model, build_optimizer("adam", 3e-4, clip_norm=1.0),
                                   attention_fn=fn)
        step = make_train_step("lm")
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for k in kernels.values():
            k.launches = 0
        losses, times = [], []
        for batch in batches:
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(float(metrics["loss"]))
        launches = {k: fn_.launches for k, fn_ in kernels.items()}
        peak = torch.cuda.max_memory_allocated()
        step_s = sorted(times[1:])[len(times[1:]) // 2]
        res = {"losses": losses, "step_times_s": times, "step_s_median": step_s,
               "tokens_per_s": B * S / step_s, "max_memory_allocated": peak,
               "launches": launches}
        log(f"14b {name}: losses {[round(x, 4) for x in losses]}, step median "
            f"{1e3 * step_s:.2f} ms (steps 2-{steps}), {res['tokens_per_s']:.0f} tokens/s, "
            f"max_memory_allocated {peak / 2**30:.2f} GiB, launches {launches} "
            f"(expected {expect[name]} a step each)")
        require(all(np.isfinite(losses)), f"14b {name}: non-finite loss {losses}")
        require(all(n == expect[name] * steps for n in launches.values()),
                f"14b {name}: expected {expect[name] * steps} launches of each kernel, got "
                f"{launches}")
        res["profile"] = device_profile(torch, lambda: step(state, batches[-1]),
                                        f"14b {name} profile (one step)")
        result[name] = res
    return result


def seq_clis(torch, card: str) -> dict:
    """14c: ``cli.train_lm --sp 1 --attention ring`` and ``ulysses`` over
    NCCL at world size 1 (2 layers at the 110M widths, seq 4096; the wiring
    only, as 13d), and ``--sp 2 --loss_chunk 256`` accepted (one process
    stops only for want of a second seq rank)."""
    import contextlib
    import io
    import shutil
    import tempfile

    from deeplearning_mpi_tpu_torch.cli import train_lm
    from deeplearning_mpi_tpu_torch.ops.kernels import flash_attention as fa
    from deeplearning_mpi_tpu_torch.runtime import bootstrap

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="phase14-", dir=os.path.join(ROOT, "build"))
    flags = P10_MODEL[2:] + ["--num_layers", "2", "--device", "cuda", "--dtype", "bfloat16",
                             "--seq_len", "4096", "--batch_size", "2", "--train_sequences", "8",
                             "--num_epochs", "1"]
    out: dict = {"card": card}

    def cli(argv):
        buf, err = io.StringIO(), io.StringIO()
        try:
            with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(err):
                rc = train_lm.main(argv)
        except SystemExit as e:
            rc = e.code
        for line in buf.getvalue().splitlines():
            log(f"  | {line}")
        return rc, buf.getvalue(), err.getvalue()

    try:
        for attention in ("ring", "ulysses"):
            fa.flash_attention_cuda.launches = 0
            t0 = time.perf_counter()
            rc, text, err = cli(flags + ["--sp", "1", "--attention", attention, "--coordinator",
                                         f"file://{os.path.join(work, attention + '-rdzv')}",
                                         "--num_processes", "1", "--process_id", "0"])
            k1 = fa.flash_attention_cuda.launches
            log(f"14c train_lm --sp 1 --attention {attention} over NCCL at world size 1 (the "
                f"wiring only: NCCL refuses two ranks on one card): exit {rc} in "
                f"{time.perf_counter() - t0:.1f}s, K1 launched {k1} times")
            require(rc == 0 and "nccl" in text and k1 > 0, f"14c {attention}: exited {rc}, K1 "
                    f"{k1}: {err[-2000:]}")
            out[attention] = {"rc": rc, "K1": k1}
        rc, _, err = cli(flags + ["--sp", "2", "--attention", "ring", "--loss_chunk", "256"])
        log(f"14c --sp 2 --loss_chunk 256 in one process: exit {rc}: {err.strip()}")
        require(rc == 1 and "needs 2 processes" in err and "ROADMAP" not in err,
                f"14c: --sp with --loss_chunk exited {rc}: {err.strip()}")
    finally:
        bootstrap.shutdown()
        shutil.rmtree(work, ignore_errors=True)
    return out


def time_seq(torch, gen, launches, *, batch: int = P14_B, seq: int = P14_S // P14_SP,
             heads: int = P14_H, where: str = "14b's ring") -> list[dict]:
    """K1, K2 and K3 at the ring's past-block call (bf16 B2 S2048 H12 D64 by
    default, ``causal=False``; K1 with a float32 output and the lse, K2/K3
    with the global lse and output and float32 gradients), beside their
    plain versions and SDPA's non-causal forward / backward (the port never
    calls SDPA); ``launches``: the ring run of ``where``."""
    import torch.nn.functional as F

    from deeplearning_mpi_tpu_torch.ops.kernels import flash_attention as fa

    B, H, S, D = batch, heads, seq, P14_D
    pairs = B * H * S * S
    tensor = B * H * S * D * 2  # one bf16 [B, S, H, D] tensor
    rowvec = B * H * S * 4
    shape = f"B{B} S{S} H{H} D{D} bf16 full (the ring's past block)"
    tag = "" if (B, S, H) == (P14_B, P14_S // P14_SP, P14_H) else f" B{B} S{S} H{H}"
    q, k, v, do = (torch.randn(B, S, H, D, generator=gen, device="cuda").bfloat16()
                   for _ in range(4))
    fwd = dict(causal=False, window=None, shift=0, return_lse=True, out_dtype=torch.float32,
               layout="bshd")
    o32, lse = fa.flash_attention_cuda(q, k, v, **fwd)
    want, _ = fa.flash_attention_reference(q, k, v, **fwd)
    o = o32.bfloat16()
    bwd = dict(causal=False, window=None, shift=0, grad_dtype=torch.float32, layout="bshd")
    dq, delta = fa.flash_attention_bwd_dq_cuda(q, k, v, o, do, lse, **bwd)
    dk, dv = fa.flash_attention_bwd_dkv_cuda(q, k, v, o, do, lse, delta, **bwd)
    gwant = fa.flash_attention_bwd_reference(q, k, v, o, do, lse, **bwd)
    sdpa = [t.transpose(1, 2) for t in (q, k, v)]
    sdpa_fwd = time_ms(lambda: F.scaled_dot_product_attention(*sdpa))
    leaves = [t.detach().requires_grad_() for t in sdpa]
    sdpa_out = F.scaled_dot_product_attention(*leaves)
    sdpa_bwd = time_ms(lambda: torch.autograd.grad(sdpa_out, leaves, do.transpose(1, 2),
                                                   retain_graph=True))
    plain_bwd = time_ms(lambda: fa.flash_attention_bwd_reference(q, k, v, o, do, lse, **bwd),
                        iters=3, warmup=1)
    rows = []

    def row(name, source, replaces, fn, flops, nbytes, **fields):
        t_ops, t_bytes = flops / PEAK_FLOPS["bfloat16"], nbytes / PEAK_BYTES
        rows.append({
            "name": name, "route": "cuda", "source": f"deeplearning_mpi_tpu_torch/csrc/{source}",
            "replaces": f"deeplearning_mpi_tpu/ops/pallas/flash_attention.py:{replaces}",
            "ms": time_ms(fn), "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops > t_bytes else "bytes", "shape": shape, **fields,
        })

    row(f"K1 flash_attention_fwd (ring block{tag}: full, f32 out, lse)",
        "flash_attention_fwd.cu", 110,
        lambda: fa.flash_attention_cuda(q, k, v, **fwd), 4 * D * pairs,
        3 * tensor + 2 * tensor + rowvec, launches=launches["K1"], max_abs_err=max_err(o32, want),
        plain_ms=time_ms(lambda: fa.flash_attention_reference(q, k, v, **fwd), iters=3, warmup=1),
        library_ms=sdpa_fwd)
    row(f"K2 flash_attention_bwd_dq (ring block{tag}: full, global lse, f32 grads)",
        "flash_attention_bwd.cu", 338,
        lambda: fa.flash_attention_bwd_dq_cuda(q, k, v, o, do, lse, **bwd), 6 * D * pairs,
        5 * tensor + rowvec + 2 * tensor + rowvec, launches=launches["K2"],
        max_abs_err=max_err(dq, gwant[0]), plain_ms=plain_bwd, library_ms=sdpa_bwd)
    row(f"K3 flash_attention_bwd_dkv (ring block{tag}: full, global lse, f32 grads)",
        "flash_attention_bwd.cu", 386,
        lambda: fa.flash_attention_bwd_dkv_cuda(q, k, v, o, do, lse, delta, **bwd),
        8 * D * pairs, 4 * tensor + 2 * rowvec + 4 * tensor, launches=launches["K3"],
        max_abs_err=max(max_err(dk, gwant[1]), max_err(dv, gwant[2])), plain_ms=plain_bwd,
        library_ms=sdpa_bwd)
    for r in rows:
        log(f"time {r['name']} [{r['shape']}]: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, sdpa {'forward' if r['name'].startswith('K1') else 'backward'}"
            f" {r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
            f"{r['launches']} launches in {where} run, max abs err {r['max_abs_err']:.3e}")
    return rows


def seq_phase(torch, card: str, gen, seed: int) -> dict:
    """Phase 14: sequence parallelism (14a-14c) and the ring's kernel rows."""
    out = {"attention": seq_attention(torch, gen)}
    torch.cuda.empty_cache()
    out["train"] = seq_train(torch, seed)
    torch.cuda.empty_cache()
    out.update(seq_clis(torch, card))
    out["kernels"] = time_seq(torch, gen, out["train"]["ring"]["launches"])
    return out


# -- phase 15 ----------------------------------------------------------------
#: Phase 15's tensor-parallel degree: 12 heads, 3 a rank.
P15_TP = 4
#: ``tests/test_generate_cli.py``'s ``TP_SHAPE`` at vocab 256 (15b).
P15_SMALL = dict(vocab_size=256, num_layers=2, num_heads=4, head_dim=16, d_model=32, d_ff=64)


def _kernel_counts(fa, fd=None) -> dict:
    counts = {"K1": fa.flash_attention_cuda.launches, "K2": fa.flash_attention_bwd_dq_cuda.launches,
              "K3": fa.flash_attention_bwd_dkv_cuda.launches}
    if fd is not None:
        counts["K4"] = fd.flash_decode_cuda.launches
    return counts


def _zero_counts(fa, fd=None) -> None:
    for fn in (fa.flash_attention_cuda, fa.flash_attention_bwd_dq_cuda,
               fa.flash_attention_bwd_dkv_cuda) + (() if fd is None else (fd.flash_decode_cuda,)):
        fn.launches = 0


def tp_train(torch, seed: int) -> dict:
    """15a: the 110M ``TransformerConfig()`` in bf16 at B8 S2048 with flash,
    sharded over ``LockstepTP(4)`` on this card (the ranks in lockstep: NCCL
    refuses two ranks on one card), from phase 8's weights and batches:
    step-1 gradients (gathered) against the unsharded flash step's within
    5e-2 relative L2 per tensor, then 6 Adam steps (3e-4, clip 1.0) with
    every loss finite and K1/K2/K3 launched 48 times a step each (12 layers
    x 4 ranks, at H3); step median, tokens/s, busy share, peak memory."""
    import numpy as np

    from deeplearning_mpi_tpu_torch.data import Loader, SyntheticTokens
    from deeplearning_mpi_tpu_torch.models.transformer import TransformerConfig, TransformerLM
    from deeplearning_mpi_tpu_torch.ops.kernels import flash_attention as fa
    from deeplearning_mpi_tpu_torch.ops.loss import lm_cross_entropy
    from deeplearning_mpi_tpu_torch.parallel.tensor_parallel import LockstepTP
    from deeplearning_mpi_tpu_torch.train import build_optimizer, create_train_state, make_train_step

    cfg = TransformerConfig()
    B, S, steps = 8, 2048, 6
    loader = Loader(SyntheticTokens(2 * B, S, vocab_size=cfg.vocab_size, seed=seed), B,
                    shuffle=True, seed=seed, device="cuda")
    batches = [b for epoch in range(steps // 2) for b in loader.epoch(epoch)]
    one = TransformerLM(cfg, dtype=torch.bfloat16, device="cuda").init_weights(seed)
    model = TransformerLM(cfg, dtype=torch.bfloat16, device="cuda",
                          tp=LockstepTP(P15_TP, "cuda")).init_weights(seed)
    whole = model.full_state_dict()
    require(all(torch.equal(whole[n], p) for n, p in one.state_dict().items()),
            "15a: the sharded model does not hold phase 8's weights")
    del whole
    n_local = sum(p.numel() for n, p in model.named_parameters() if ".shards.0." in n or
                  ".shards." not in n)

    def grads(m):
        m.zero_grad(set_to_none=True)
        tokens = batches[0]["tokens"]
        lm_cross_entropy(m(tokens, attention_fn=fa.flash_attention_bhsd), tokens).backward()
        g = {n: p.grad.float() for n, p in m.named_parameters()}
        m.zero_grad(set_to_none=True)
        return g if m.tp_layout is None else m.tp_layout.gather(g)

    g_one = grads(one)
    del one
    g_tp = grads(model)
    rel = {n: float((g_tp[n] - g.float()).norm() / g.norm().clamp(min=1e-30))
           for n, g in g_one.items()}
    worst = max(rel, key=rel.get)
    log(f"15a tp {P15_TP} vs unsharded flash step-1 grads (B{B} S{S}, {len(rel)} tensors): "
        f"relative L2 error max {rel[worst]:.3e} ({worst}), median "
        f"{sorted(rel.values())[len(rel) // 2]:.3e} (tol 5e-2); a rank holds {n_local} of "
        f"{sum(g.numel() for g in g_one.values())} parameters")
    require(rel[worst] <= 5e-2, f"15a: tp grads differ from the unsharded step: {worst} "
            f"{rel[worst]}")
    del g_one, g_tp
    torch.cuda.empty_cache()
    state = create_train_state(model, build_optimizer("adam", 3e-4, clip_norm=1.0),
                               attention_fn=fa.flash_attention_bhsd)
    step = make_train_step("lm")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts(fa)
    losses, times = [], []
    for batch in batches:
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
    launches = _kernel_counts(fa)
    peak = torch.cuda.max_memory_allocated()
    step_s = sorted(times[1:])[len(times[1:]) // 2]
    expect = 12 * P15_TP
    result = {"grads_rel_l2_max": rel[worst], "grads_worst": worst, "losses": losses,
              "step_times_s": times, "step_s_median": step_s, "tokens_per_s": B * S / step_s,
              "max_memory_allocated": peak, "launches": launches, "params_a_rank": n_local}
    log(f"15a tp {P15_TP}: losses {[round(x, 4) for x in losses]}, step median "
        f"{1e3 * step_s:.2f} ms (steps 2-{steps}), {result['tokens_per_s']:.0f} tokens/s, "
        f"max_memory_allocated {peak / 2**30:.2f} GiB, launches {launches} (expected {expect} "
        f"a step each)")
    require(all(np.isfinite(losses)), f"15a: non-finite loss {losses}")
    require(all(n == expect * steps for n in launches.values()),
            f"15a: expected {expect * steps} launches of each kernel, got {launches}")
    result["profile"] = device_profile(torch, lambda: step(state, batches[-1]),
                                       "15a profile (one tp step)")
    return result


def tp_card_vs_cpu(torch, seed: int) -> dict:
    """15b: ``TP_SHAPE`` under ``LockstepTP(2)``, float32 with TF32 off, the
    same weights and batch (B8 S32) on the card (K1-K3 at H2) and on the CPU
    (their plain versions): the loss within 1e-4 relative and every step-1
    gradient within 1e-4 relative L2."""
    import numpy as np

    from deeplearning_mpi_tpu_torch.models.transformer import TransformerConfig, TransformerLM
    from deeplearning_mpi_tpu_torch.ops.kernels import flash_attention as fa
    from deeplearning_mpi_tpu_torch.ops.loss import lm_cross_entropy
    from deeplearning_mpi_tpu_torch.parallel.tensor_parallel import LockstepTP

    cfg = TransformerConfig(**P15_SMALL)
    tokens = torch.from_numpy(np.random.default_rng(seed).integers(0, 256, (8, 32)))

    def run(device):
        m = TransformerLM(cfg, dtype=torch.float32, device=device,
                          tp=LockstepTP(2, device)).init_weights(seed)
        t = tokens.to(device)
        loss = lm_cross_entropy(m(t, attention_fn=fa.flash_attention_bhsd), t)
        names, params = zip(*m.named_parameters())
        g = m.tp_layout.gather(dict(zip(names, torch.autograd.grad(loss, params))))
        return float(loss.detach()), {n: x.cpu().double() for n, x in g.items()}

    (loss_gpu, g_gpu), (loss_cpu, g_cpu) = run("cuda"), run("cpu")
    rel = {n: float((g_gpu[n] - g).norm() / g.norm().clamp(min=1e-30)) for n, g in g_cpu.items()}
    worst = max(rel, key=rel.get)
    loss_rel = abs(loss_gpu - loss_cpu) / abs(loss_cpu)
    log(f"15b tp 2 card vs CPU (TP_SHAPE, float32, TF32 off): loss {loss_gpu:.6f} vs "
        f"{loss_cpu:.6f} ({loss_rel:.2e}), worst gradient {rel[worst]:.3e} ({worst}) (tol 1e-4)")
    require(loss_rel <= 1e-4 and rel[worst] <= 1e-4,
            f"15b: card differs from CPU: loss {loss_rel}, {worst} {rel[worst]}")
    return {"loss_rel": loss_rel, "grads_rel_l2_max": rel[worst], "grads_worst": worst}


def tp_generate(torch, seed: int) -> dict:
    """15c: the 110M ``TransformerConfig()`` in float32 (phase 5's weights)
    under ``LockstepTP(4)`` on this card: greedy generation of 2 prompts of
    64 tokens, 16 new, token-identical to the unsharded model; K1 launched
    4 x 12 times for the prefill and K4 4 x 12 times a decode step."""
    import numpy as np

    from deeplearning_mpi_tpu_torch.models.generate import generate
    from deeplearning_mpi_tpu_torch.models.transformer import TransformerConfig, TransformerLM
    from deeplearning_mpi_tpu_torch.ops.kernels import flash_attention as fa
    from deeplearning_mpi_tpu_torch.ops.kernels import flash_decode as fd
    from deeplearning_mpi_tpu_torch.parallel.tensor_parallel import LockstepTP

    cfg = TransformerConfig()
    new = 16
    prompt = torch.from_numpy(
        np.random.default_rng(seed).integers(0, cfg.vocab_size, (2, 64))).cuda()
    one = TransformerLM(cfg, dtype=torch.float32, device="cuda").init_weights(seed)
    want = generate(one, prompt, max_new_tokens=new, temperature=0.0)
    del one
    model = TransformerLM(cfg, dtype=torch.float32, device="cuda",
                          tp=LockstepTP(P15_TP, "cuda")).init_weights(seed)
    _zero_counts(fa, fd)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = generate(model, prompt, max_new_tokens=new, temperature=0.0)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _kernel_counts(fa, fd)
    expect = {"K1": 12 * P15_TP, "K4": 12 * P15_TP * (new - 1)}
    same = bool(torch.equal(got, want))
    log(f"15c tp {P15_TP} greedy generation (f32, B2, 64 + {new} tokens): token-identical to "
        f"tp 1: {same}, {seconds:.3f}s, K1 {launches['K1']} (expected {expect['K1']}), K4 "
        f"{launches['K4']} (expected {expect['K4']})")
    require(same, f"15c: tp {P15_TP} tokens {got.tolist()} differ from tp 1's {want.tolist()}")
    require(launches["K1"] == expect["K1"] and launches["K4"] == expect["K4"],
            f"15c: launches {launches}, expected {expect}")
    return {"token_identical": same, "seconds": seconds, "launches": launches,
            "decode_steps": 2 * (new - 1)}


def tp_zero_cli(torch, card: str) -> dict:
    """15d: ``cli.train_lm --tp 1 --zero_overlap`` over NCCL at world size 1
    (2 layers at the 110M widths, seq 1024): the wiring only, as 13d and
    14c; it runs and logs the reference's fallback reason."""
    import contextlib
    import io
    import shutil
    import tempfile

    from deeplearning_mpi_tpu_torch.cli import train_lm
    from deeplearning_mpi_tpu_torch.runtime import bootstrap

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="phase15-", dir=os.path.join(ROOT, "build"))
    flags = P10_MODEL[2:] + ["--num_layers", "2", "--device", "cuda", "--dtype", "bfloat16",
                             "--attention", "flash", "--seq_len", "1024", "--batch_size", "2",
                             "--train_sequences", "8", "--num_epochs", "1", "--tp", "1",
                             "--zero_overlap", "--coordinator",
                             f"file://{os.path.join(work, 'rdzv')}", "--num_processes", "1",
                             "--process_id", "0"]
    buf, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(err):
            rc = train_lm.main(flags)
    finally:
        bootstrap.shutdown()
        shutil.rmtree(work, ignore_errors=True)
    text = buf.getvalue()
    for line in text.splitlines():
        log(f"  | {line}")
    fell_back = "no data parallelism" in text and "falling back" in text
    log(f"15d train_lm --tp 1 --zero_overlap over NCCL at world size 1 ({card}): exit {rc} in "
        f"{time.perf_counter() - t0:.1f}s, fallback logged: {fell_back}")
    require(rc == 0 and "nccl" in text and fell_back,
            f"15d: exited {rc}, fallback {fell_back}: {err.getvalue()[-2000:]}")
    return {"rc": rc, "fallback_logged": fell_back}


def tp_phase(torch, card: str, gen, seed: int) -> dict:
    """Phase 15: tensor parallelism (15a-15c), the ZeRO-1 wiring (15d) and
    the kernel rows at a tp-4 rank's local heads."""
    out = {"train": tp_train(torch, seed)}
    torch.cuda.empty_cache()
    out["card_vs_cpu"] = tp_card_vs_cpu(torch, seed)
    out["generate"] = tp_generate(torch, seed)
    torch.cuda.empty_cache()
    out["zero_cli"] = tp_zero_cli(torch, card)
    heads = 12 // P15_TP
    out["kernels"] = time_training(torch, gen, out["train"]["launches"], heads=heads,
                                   where="15a (6 steps)")
    k4 = k4_row(torch, gen, out["generate"]["launches"]["K4"], serve_fills(), 1024, heads=heads,
                name=f"K4 flash_decode (tp {P15_TP} local heads)")
    log(f"time {k4['name']} [{k4['shape']}]: kernel {k4['ms']:.4f} ms (warm "
        f"{k4['warm_ms']:.4f}), plain {k4['plain_ms']:.4f} ms, sdpa {k4['library_ms']:.4f} ms, "
        f"bound {k4['bound_ms']:.4f} ms ({k4['bound_by']}), {k4['launches']} launches in 15c")
    out["kernels"].append(k4)
    return out


# -- phase 16 ----------------------------------------------------------------
#: Phase 16's pipeline: 4 stages of 3 blocks, 4 microbatches (B8 -> B2 each).
P16_PP, P16_MICRO = 4, 4
#: 16b's widths: ``TransformerConfig.tiny()`` at 4 layers.
P16_SMALL = dict(vocab_size=256, num_layers=4, num_heads=4, head_dim=8, d_model=32, d_ff=64)
#: 16c's ViT training through ``cli.train_resnet``: Adam, as the reference's
#: ViT test trains it, at 1e-4 (1e-3 with no warmup sends vit_small's bf16
#: loss from 2.6 to 4.5 in a step on the H100); 256 synthetic images, 4
#: steps an epoch.
P16_VIT = ["--arch", "vit_small", "--synthetic", "--train_samples", "256", "--batch_size", "64",
           "--num_epochs", "3", "--optimizer", "adam", "--learning_rate", "1e-4"]


def _flat_grads(model) -> dict:
    """A model's ``.grad`` s as the flat ``TransformerLM``'s, float32 (a
    pipelined model's remapped ``stages[block_j][s] -> layers.{s*K+j}``)."""
    from deeplearning_mpi_tpu_torch.models.convert import flat_from_stacked

    g = {n: p.grad.float() for n, p in model.named_parameters()}
    layout = getattr(model, "pipe_layout", None)
    return g if layout is None else flat_from_stacked(layout.gather(g))


def pp_train(torch, seed: int) -> dict:
    """16a: the 110M ``TransformerConfig()`` in bf16 at B8 S2048 with flash,
    as ``PipelinedLM`` over ``LockstepPipe(4)`` (3 blocks a stage, the stages
    tick by tick on this card: NCCL refuses two ranks on one card) with 4
    microbatches, from phase 8's weights and batches: step-1 gradients,
    remapped flat, within 5e-2 relative L2 per tensor of the flat flash
    step's; then 6 Adam steps (3e-4, clip 1.0) with every loss finite and
    K1/K2/K3 launched exactly 48 times a step each (12 layers x 4
    microbatches: no bubble work); step median, tokens/s, MFU, peak memory,
    one profiled step."""
    import numpy as np

    from deeplearning_mpi_tpu_torch.data import Loader, SyntheticTokens
    from deeplearning_mpi_tpu_torch.models.pipeline_lm import PipelinedLM
    from deeplearning_mpi_tpu_torch.models.transformer import TransformerConfig, TransformerLM
    from deeplearning_mpi_tpu_torch.ops.kernels import flash_attention as fa
    from deeplearning_mpi_tpu_torch.ops.loss import lm_cross_entropy
    from deeplearning_mpi_tpu_torch.parallel.pipeline import LockstepPipe
    from deeplearning_mpi_tpu_torch.telemetry.flops import transformer_train_flops
    from deeplearning_mpi_tpu_torch.train import build_optimizer, create_train_state, make_train_step

    cfg = TransformerConfig()
    B, S, steps = 8, 2048, 6
    loader = Loader(SyntheticTokens(2 * B, S, vocab_size=cfg.vocab_size, seed=seed), B,
                    shuffle=True, seed=seed, device="cuda")
    batches = [b for epoch in range(steps // 2) for b in loader.epoch(epoch)]
    one = TransformerLM(cfg, dtype=torch.bfloat16, device="cuda").init_weights(seed)
    model = PipelinedLM(cfg, num_stages=P16_PP, num_microbatches=P16_MICRO, dtype=torch.bfloat16,
                        device="cuda", pipe=LockstepPipe(P16_PP)).init_weights(seed)
    whole = model.full_state_dict()
    require(all(torch.equal(whole[n], p) for n, p in one.state_dict().items()),
            "16a: the pipelined model does not hold phase 8's weights")
    del whole

    def grads(m):
        m.zero_grad(set_to_none=True)
        tokens = batches[0]["tokens"]
        lm_cross_entropy(m(tokens, attention_fn=fa.flash_attention_bhsd), tokens).backward()
        g = _flat_grads(m)
        m.zero_grad(set_to_none=True)
        return g

    g_one = grads(one)
    del one
    g_pp = grads(model)
    rel = {n: float((g_pp[n] - g).norm() / g.norm().clamp(min=1e-30)) for n, g in g_one.items()}
    worst = max(rel, key=rel.get)
    log(f"16a pp {P16_PP} x {P16_MICRO} microbatches vs flat flash step-1 grads (B{B} S{S}, "
        f"{len(rel)} tensors): relative L2 error max {rel[worst]:.3e} ({worst}), median "
        f"{sorted(rel.values())[len(rel) // 2]:.3e} (tol 5e-2)")
    require(rel[worst] <= 5e-2, f"16a: pipelined grads differ from the flat step: {worst} "
            f"{rel[worst]}")
    del g_one, g_pp
    torch.cuda.empty_cache()
    state = create_train_state(model, build_optimizer("adam", 3e-4, clip_norm=1.0),
                               attention_fn=fa.flash_attention_bhsd)
    step = make_train_step("lm")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts(fa)
    losses, times = [], []
    for batch in batches:
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
    launches = _kernel_counts(fa)
    peak = torch.cuda.max_memory_allocated()
    step_s = sorted(times[1:])[len(times[1:]) // 2]
    expect = 12 * P16_MICRO
    flops = transformer_train_flops(cfg, B, S)
    result = {"grads_rel_l2_max": rel[worst], "grads_worst": worst, "losses": losses,
              "step_times_s": times, "step_s_median": step_s, "tokens_per_s": B * S / step_s,
              "model_flops_per_step": flops, "mfu": flops / step_s / PEAK_FLOPS["bfloat16"],
              "max_memory_allocated": peak, "launches": launches}
    log(f"16a pp {P16_PP}: losses {[round(x, 4) for x in losses]}, step median "
        f"{1e3 * step_s:.2f} ms (steps 2-{steps}), {result['tokens_per_s']:.0f} tokens/s, MFU "
        f"{100 * result['mfu']:.2f}% of 989 TFLOP/s, max_memory_allocated "
        f"{peak / 2**30:.2f} GiB, launches {launches} (expected {expect} a step each)")
    require(all(np.isfinite(losses)), f"16a: non-finite loss {losses}")
    require(all(n == expect * steps for n in launches.values()),
            f"16a: expected {expect * steps} launches of each kernel, got {launches}")
    result["profile"] = device_profile(torch, lambda: step(state, batches[-1]),
                                       "16a profile (one pp step)")
    return result


def pp_card_vs_cpu(torch, seed: int) -> dict:
    """16b: ``P16_SMALL`` as ``PipelinedLM`` over ``LockstepPipe(2)``, 2
    microbatches, float32 with TF32 off, the same weights and batch (B4 S32)
    on the card (K1-K3) and on the CPU (their plain versions): the loss
    within 1e-4 relative and every step-1 gradient within 1e-4 relative L2;
    then ``tiny_moe`` the same way: the load-balance loss within 1e-5."""
    import numpy as np

    from deeplearning_mpi_tpu_torch.models import moe
    from deeplearning_mpi_tpu_torch.models.pipeline_lm import PipelinedLM
    from deeplearning_mpi_tpu_torch.models.transformer import TransformerConfig
    from deeplearning_mpi_tpu_torch.ops.kernels import flash_attention as fa
    from deeplearning_mpi_tpu_torch.ops.loss import lm_cross_entropy
    from deeplearning_mpi_tpu_torch.parallel.pipeline import LockstepPipe

    tokens = torch.from_numpy(np.random.default_rng(seed).integers(0, 256, (4, 32)))

    def run(cfg, device):
        m = PipelinedLM(cfg, num_stages=2, num_microbatches=2, dtype=torch.float32,
                        device=device, pipe=LockstepPipe(2)).init_weights(seed)
        t = tokens.to(device)
        with moe.collecting(m) as sown:
            loss = lm_cross_entropy(m(t, attention_fn=fa.flash_attention_bhsd), t)
            aux = float(moe.collect_aux_loss(sown).detach()) if sown.aux else None
        loss.backward()
        return float(loss.detach()), aux, {n: g.cpu().double() for n, g in _flat_grads(m).items()}

    cfg = TransformerConfig(**P16_SMALL)
    (loss_gpu, _, g_gpu), (loss_cpu, _, g_cpu) = run(cfg, "cuda"), run(cfg, "cpu")
    rel = {n: float((g_gpu[n] - g).norm() / g.norm().clamp(min=1e-30)) for n, g in g_cpu.items()}
    worst = max(rel, key=rel.get)
    loss_rel = abs(loss_gpu - loss_cpu) / abs(loss_cpu)
    moe_cfg = TransformerConfig.tiny_moe()
    (_, aux_gpu, _), (_, aux_cpu, _) = run(moe_cfg, "cuda"), run(moe_cfg, "cpu")
    log(f"16b pp 2 card vs CPU (4 layers, float32, TF32 off): loss {loss_gpu:.6f} vs "
        f"{loss_cpu:.6f} ({loss_rel:.2e}), worst gradient {rel[worst]:.3e} ({worst}) (tol 1e-4); "
        f"tiny_moe aux {aux_gpu:.8f} vs {aux_cpu:.8f} (tol 1e-5)")
    require(loss_rel <= 1e-4 and rel[worst] <= 1e-4,
            f"16b: card differs from CPU: loss {loss_rel}, {worst} {rel[worst]}")
    require(abs(aux_gpu - aux_cpu) <= 1e-5, f"16b: MoE aux {aux_gpu} vs CPU {aux_cpu}")
    return {"loss_rel": loss_rel, "grads_rel_l2_max": rel[worst], "grads_worst": worst,
            "aux_card": aux_gpu, "aux_cpu": aux_cpu}


def vit_train_flops(batch: int, *, image_size: int = 32, patch: int = 4, layers: int = 12,
                    heads: int = 6, head_dim: int = 64, d: int = 384, d_ff: int = 1536,
                    classes: int = 10) -> float:
    """Model FLOPs of one ViT train step, counted as the LM's
    (``telemetry.flops.transformer_train_flops``; the reference counts none
    for the ViT): 3x
    the forward's matmuls (the patch conv, per token and block 2*d*3*H*Dh
    q/k/v, 2*H*Dh*d out, 4*T*H*Dh full attention, 6*d*d_ff SwiGLU; the
    head on the CLS row)."""
    patches = (image_size // patch) ** 2
    tokens = patches + 1
    hd = heads * head_dim
    per_token = 2 * d * 3 * hd + 2 * hd * d + 4 * tokens * hd + 6 * d * d_ff
    forward = (2 * patch * patch * 3 * d * patches + tokens * layers * per_token
               + 2 * d * classes)
    return 3.0 * batch * forward


def vit_phase(torch, card: str, seed: int) -> dict:
    """16c: ``vit_small`` in float32 with TF32 off, B32 synthetic CIFAR on
    the card and on the CPU (same weights): every gradient within 1e-4
    relative L2; then ``cli.train_resnet --arch vit_small --synthetic
    --dtype bfloat16`` over NCCL at world size 1 (phase 12's bars:
    finite, falling (memorisation), one gradient all-reduce a step, an
    eval): step median and images/s."""
    import shutil
    import tempfile

    from deeplearning_mpi_tpu_torch.cli import train_resnet
    from deeplearning_mpi_tpu_torch.data import Loader, SyntheticCIFAR10
    from deeplearning_mpi_tpu_torch.data.cifar10 import train_transform
    from deeplearning_mpi_tpu_torch.models.vit import vit_small
    from deeplearning_mpi_tpu_torch.ops.loss import softmax_cross_entropy
    from deeplearning_mpi_tpu_torch.runtime import bootstrap

    batch = next(iter(Loader(SyntheticCIFAR10(32, seed=seed), 32, shuffle=False,
                             transform=train_transform, device="cpu").epoch(0)))
    out = {}
    for device in ("cuda", "cpu"):
        m = vit_small(dtype=torch.float32, device=device).init_weights(seed)
        loss = softmax_cross_entropy(m(batch["image"].to(device)), batch["label"].to(device))
        names, params = zip(*m.named_parameters())
        g = torch.autograd.grad(loss, params)
        out[device] = (float(loss.detach()), {n: x.cpu().double() for n, x in zip(names, g)})
    rel = {n: float((out["cuda"][1][n] - g).norm() / g.norm().clamp(min=1e-30))
           for n, g in out["cpu"][1].items()}
    worst = max(rel, key=rel.get)
    loss_rel = abs(out["cuda"][0] - out["cpu"][0]) / abs(out["cpu"][0])
    log(f"16c vit_small card vs CPU (B32, float32, TF32 off, {len(rel)} tensors): loss rel "
        f"{loss_rel:.2e}, worst gradient {rel[worst]:.3e} ({worst}), median "
        f"{sorted(rel.values())[len(rel) // 2]:.3e} (tol 1e-4)")
    require(loss_rel <= 1e-4 and rel[worst] <= 1e-4,
            f"16c: card differs from CPU: loss {loss_rel}, {worst} {rel[worst]}")
    result = {"grads_rel_l2_max": rel[worst], "grads_worst": worst, "loss_rel": loss_rel}
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="phase16-", dir=os.path.join(ROOT, "build"))
    try:
        w = train_workload(torch, card, train_resnet, P16_VIT, task="classification",
                           dtype="bfloat16", flops_per_step=vit_train_flops(64),
                           rdzv=os.path.join(work, "vit"), model_dir=None, check_rows=8,
                           metric="accuracy", label="16c train_resnet --arch vit_small")
        w.pop("run")
        w.pop("final_digests")
    finally:
        bootstrap.shutdown()
        shutil.rmtree(work, ignore_errors=True)
    result["train"] = w
    return result


def pp_seq_refusal() -> dict:
    """18a: ``cli.train_lm --pp 2 --sp 2 --attention ring`` and ``ulysses``
    exit 1 with the reason the reference raises on them and their ROADMAP
    item."""
    import contextlib
    import io

    from deeplearning_mpi_tpu_torch.cli import train_lm
    from deeplearning_mpi_tpu_torch.utils.config import PP_SEQ_REASON

    out = {}
    for schedule in ("ring", "ulysses"):
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            rc = train_lm.main(["--device", "cuda", "--pp", "2", "--sp", "2", "--attention",
                                schedule])
        text = err.getvalue().strip()
        log(f"18a train_lm --pp 2 --sp 2 --attention {schedule}: exit {rc}: {text}")
        require(rc == 1 and "item 8.6" in text and PP_SEQ_REASON in text,
                f"18a: exit {rc}: {text}")
        out[schedule] = {"rc": rc, "message": text}
    return out


def pp_phase(torch, card: str, gen, seed: int) -> dict:
    """Phase 16: pipeline parallelism (16a, 16b), the ViT family (16c) and
    the kernel rows at the microbatch call."""
    out = {"train": pp_train(torch, seed)}
    torch.cuda.empty_cache()
    out["card_vs_cpu"] = pp_card_vs_cpu(torch, seed)
    out["vit"] = vit_phase(torch, card, seed)
    torch.cuda.empty_cache()
    out["kernels"] = time_training(torch, gen, out["train"]["launches"], where="16a (6 steps)",
                                   batch=8 // P16_MICRO)
    return out


# -- phase 17 ----------------------------------------------------------------
#: Phase 17's compositions, each in the one-process grid (two lockstep axes
#: side by side, ``parallel.seq_common``: NCCL refuses two ranks on one card):
#: name -> (what it runs, B, S, K1/K2/K3 launches a step each). 17a: the 110M
#: model as ``PipelinedLM`` over pp 2 x tp 2 with 4 microbatches (12 layers x
#: 4 microbatches x 2 model ranks at B2 H6). 17b: tp 2 x sp 2 at phase 14b's
#: B2 S8192, the ring (3 K1 calls a layer and model rank at sp 2: the
#: diagonal block and one past block) and Ulysses (one whole-sequence call
#: a layer, model rank and seq rank, at H3). 17c: phase 13a's MoE LM with
#: its routing shard by shard over ``LockstepRing(2)`` and the ring over the
#: same 2 shards (3 a layer). 17d: the MoE LM over tp 2, attention and each
#: expert's d_ff split (a layer's one call a model rank, at B8 H6).
#: 17a-17d's depth: 4 of the 110M model's 12 blocks (widths kept), so that
#: phase 21 fits the script's time.
P17_LAYERS = 4
P17_CASES = {
    "17a pp2 x tp2": ("pp_tp", 8, 2048, P17_LAYERS * 4 * 2),
    "17b tp2 x sp2 ring": ("tp_sp_ring", 2, 8192, P17_LAYERS * 2 * 3),
    "17b tp2 x sp2 ulysses": ("tp_sp_ulysses", 2, 8192, P17_LAYERS * 2 * 2),
    "17c moe x sp2 ring": ("moe_sp", 8, 2048, P17_LAYERS * 3),
    "17d moe x tp2": ("moe_tp", 8, 2048, P17_LAYERS * 2),
}
P17_STEPS = 4


def _compose_model(torch, kind: str, seed: int):
    """``(model, attention fn, flat reference model, its attention fn)`` of
    one phase-17 composition, bf16, from ``seed``'s weights."""
    from deeplearning_mpi_tpu_torch.models.pipeline_lm import PipelinedLM
    from deeplearning_mpi_tpu_torch.models.transformer import TransformerConfig, TransformerLM
    from deeplearning_mpi_tpu_torch.ops.kernels import flash_attention as fa
    from deeplearning_mpi_tpu_torch.parallel import make_ring_attention_fn, make_ulysses_attention_fn
    from deeplearning_mpi_tpu_torch.parallel.pipeline import LockstepPipe
    from deeplearning_mpi_tpu_torch.parallel.seq_common import LockstepRing
    from deeplearning_mpi_tpu_torch.parallel.tensor_parallel import LockstepTP

    moe = kind.startswith("moe")
    cfg = (moe_config(num_layers=P17_LAYERS) if moe
           else TransformerConfig(num_layers=P17_LAYERS))
    tp = (LockstepTP(2, "cuda") if kind in ("pp_tp", "tp_sp_ring", "tp_sp_ulysses", "moe_tp")
          else None)
    if kind == "pp_tp":
        model = PipelinedLM(cfg, num_stages=2, num_microbatches=4, dtype=torch.bfloat16,
                            device="cuda", pipe=LockstepPipe(2), tp=tp)
    else:
        model = TransformerLM(cfg, dtype=torch.bfloat16, device="cuda", tp=tp,
                              seq=LockstepRing(2) if kind == "moe_sp" else None)
    model.init_weights(seed)
    fn = (make_ulysses_attention_fn(sp=2, head_groups=2) if kind == "tp_sp_ulysses"
          else make_ring_attention_fn(sp=2) if kind in ("tp_sp_ring", "moe_sp")
          else fa.flash_attention_bhsd)
    flat = TransformerLM(cfg, dtype=torch.bfloat16, device="cuda").init_weights(seed)
    return model, fn, flat, fa.flash_attention_bhsd


def _model_grads(torch, model, attention_fn, tokens, aux_weight: float) -> dict:
    """Step-1 gradients of the loss (and the weighted balance loss), whole
    and with the flat model's names, float32."""
    from deeplearning_mpi_tpu_torch.models.convert import flat_from_stacked
    from deeplearning_mpi_tpu_torch.models.moe import collect_aux_loss, collecting
    from deeplearning_mpi_tpu_torch.ops.loss import lm_cross_entropy

    model.zero_grad(set_to_none=True)
    with collecting(model) as sown:
        loss = lm_cross_entropy(model(tokens, attention_fn=attention_fn), tokens)
        if sown.aux:
            loss = loss + aux_weight * collect_aux_loss(sown)
        loss.backward()
    g = {n: p.grad.float() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    layout = getattr(model, "layout", None) or getattr(model, "tp_layout", None)
    g = g if layout is None else layout.gather(g)
    return flat_from_stacked(g) if hasattr(model, "pipe_layout") else g


def compose_train(torch, name: str, seed: int) -> dict:
    """One of 17a-17d (:data:`P17_CASES`), bf16, Adam 3e-4 with clip 1.0
    (the MoE balance loss weighted 0.01): step-1 gradients, gathered whole,
    against the flat model's flash step within 5e-2 relative L2 per tensor
    (phases 14b / 15a / 16a's bar); then :data:`P17_STEPS` steps through
    ``make_train_step`` on 2 batches of seeded sequences, every loss finite,
    the mean of the last 3 below the first (memorisation), K1/K2/K3 launched
    exactly the expected count a step each; a second run of 2 steps from the
    same weights bitwise equal (losses and parameters); step median,
    tokens/s, peak memory, one profiled step."""
    import numpy as np

    from deeplearning_mpi_tpu_torch.data import SyntheticTokens
    from deeplearning_mpi_tpu_torch.ops.kernels import flash_attention as fa
    from deeplearning_mpi_tpu_torch.train import build_optimizer, create_train_state, make_train_step

    kind, B, S, expect = P17_CASES[name]
    aux_weight = MOE_AUX_WEIGHT if kind.startswith("moe") else 0.0
    model, fn, flat, flat_fn = _compose_model(torch, kind, seed)
    ds = SyntheticTokens(2 * B, S, vocab_size=model.config.vocab_size, seed=seed)
    rows = np.stack([ds[i]["tokens"] for i in range(2 * B)])
    batches = [{"tokens": torch.from_numpy(rows[i * B:(i + 1) * B]).cuda()}
               for i in (0, 1)] * (P17_STEPS // 2)
    init = {n: p.detach().clone() for n, p in model.named_parameters()}
    g_flat = _model_grads(torch, flat, flat_fn, batches[0]["tokens"], aux_weight)
    del flat
    g = _model_grads(torch, model, fn, batches[0]["tokens"], aux_weight)
    rel = {n: float((g[n] - w).norm() / w.norm().clamp(min=1e-30)) for n, w in g_flat.items()}
    worst = max(rel, key=rel.get)
    log(f"{name} vs the flat flash step, step-1 grads (B{B} S{S}, {len(rel)} tensors): relative "
        f"L2 error max {rel[worst]:.3e} ({worst}), median "
        f"{sorted(rel.values())[len(rel) // 2]:.3e} (tol 5e-2)")
    require(rel[worst] <= 5e-2, f"{name}: grads differ from the flat step: {worst} {rel[worst]}")
    del g, g_flat
    torch.cuda.empty_cache()

    def run(steps: int, profile: bool = False):
        with torch.no_grad():
            for n, p in model.named_parameters():
                p.copy_(init[n])
        state = create_train_state(model, build_optimizer("adam", 3e-4, clip_norm=1.0),
                                   attention_fn=fn)
        step = make_train_step("lm", aux_weight=aux_weight)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_counts(fa)
        losses, times = [], []
        for batch in batches[:steps]:
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(float(metrics["loss"]))
        launches = _kernel_counts(fa)
        prof = (device_profile(torch, lambda: step(state, batches[-1]), f"{name} profile "
                               "(one step)") if profile else None)
        return state, losses, times, launches, prof

    state, losses, times, launches, _ = run(2)
    first = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    state, again, _, _, _ = run(2)
    same = again == losses and all(torch.equal(p, first[n])
                                   for n, p in state.model.named_parameters())
    require(same, f"{name}: a second run differs (losses {losses} vs {again})")
    del first
    state, losses, times, launches, prof = run(P17_STEPS, profile=True)
    peak = torch.cuda.max_memory_allocated()
    step_s = sorted(times[1:])[len(times[1:]) // 2]
    result = {"grads_rel_l2_max": rel[worst], "grads_worst": worst, "losses": losses,
              "step_times_s": times, "step_s_median": step_s, "tokens_per_s": B * S / step_s,
              "max_memory_allocated": peak, "launches": launches, "second_run_bitwise": same,
              "profile": prof}
    log(f"{name}: losses {[round(x, 4) for x in losses]}, step median {1e3 * step_s:.2f} ms "
        f"(steps 2-{P17_STEPS}), {result['tokens_per_s']:.0f} tokens/s, max_memory_allocated "
        f"{peak / 2**30:.2f} GiB, launches {launches} (expected {expect} a step each), busy "
        f"{100 * prof['busy_share']:.2f}%; a second run bit-identical")
    require(all(np.isfinite(losses)), f"{name}: non-finite loss {losses}")
    require(np.mean(losses[-3:]) < losses[0], f"{name}: the loss did not fall: {losses}")
    require(all(n == expect * P17_STEPS for n in launches.values()),
            f"{name}: expected {expect * P17_STEPS} launches of each kernel, got {launches}")
    del state, model, init
    torch.cuda.empty_cache()
    return result


#: 17e: a tp-4 rank's heads of the 110M model (12 / 4) under Ulysses over
#: sp 2, at 14a's B2 S8192 D64; each seq rank's inner gets B * 3 / 2 rows.
P17E_TP, P17E_SP = 4, 2


def ulysses_pairs(torch, gen) -> dict:
    """17e: Ulysses over the (batch, head) pairs (``parallel.ulysses``'s
    form where sp divides the model's heads but not a model rank's), bf16
    causal: output and gradients held to ``FWD_TOL`` / ``GRAD_TOL`` against
    the same schedule on the plain versions of K1-K3 and against one K1 /
    K2+K3 call over the whole sequence; a second run bit-identical; the
    launches of one forward and backward (one K1, K2 and K3 call a seq
    rank)."""
    from deeplearning_mpi_tpu_torch.ops.kernels import flash_attention as fa
    from deeplearning_mpi_tpu_torch.parallel import make_ulysses_attention_fn

    B, S, H, D = P14_B, P14_S, P14_H // P17E_TP, P14_D
    q, k, v, do = (torch.randn(B, S, H, D, generator=gen, device="cuda").bfloat16()
                   for _ in range(4))
    kernel_fn, plain_fn = (make_ulysses_attention_fn(sp=P17E_SP, head_groups=P17E_TP, **kw)
                           for kw in ({}, {"inner": _plain_flash_fn(torch)}))
    run = lambda fn: _attention_and_grads(torch, lambda *t: fn(*t, causal=True), q, k, v, do)  # noqa: E731
    _zero_counts(fa)
    got = run(kernel_fn)
    torch.cuda.synchronize()
    launches = _kernel_counts(fa)
    again = run(kernel_fn)
    require(all(torch.equal(a, b) for a, b in zip(got, again)), "17e: a second run differs")
    require(all(n == P17E_SP for n in launches.values()),
            f"17e: expected {P17E_SP} launches of each kernel, got {launches}")
    whole, _ = _whole_sequence(torch, q, k, v, do, True, None, None)
    errs = []
    for ref_name, ref in (("plain", run(plain_fn)), ("whole", whole)):
        for label, g, r, tol in zip(("out", "dq", "dk", "dv"), got, ref,
                                    (FWD_TOL, GRAD_TOL, GRAD_TOL, GRAD_TOL)):
            atol, rtol, l2 = tol["bfloat16"]
            require(g.dtype == r.dtype and g.shape == r.shape and bool(torch.isfinite(g).all()),
                    f"17e: {label} {g.dtype}{tuple(g.shape)} vs {ref_name} {r.dtype}"
                    f"{tuple(r.shape)}, or non-finite")
            ok, err, rel = grads_close(g, r, atol, rtol, l2)
            errs.append({"vs": ref_name, "tensor": label, "max_abs_err": err, "rel_l2": rel})
            require(ok, f"17e: {label} vs {ref_name}: max abs err {err}, rel L2 {rel} (bound "
                    f"atol {atol:g} + rtol {rtol:g}, rel L2 {l2:g})")
    worst = {r: max(e["rel_l2"] for e in errs if e["vs"] == r) for r in ("plain", "whole")}
    log(f"17e ulysses pairs, tp {P17E_TP} x sp {P17E_SP}, B{B} S{S} H{H} D{D} (K1-K3 on "
        f"{B * H // P17E_SP} single-head rows): out, dq, dk, dv within FWD_TOL / GRAD_TOL of the "
        f"plain schedule (worst rel L2 {worst['plain']:.3e}) and of one whole-sequence K1 / "
        f"K2+K3 call ({worst['whole']:.3e}); launches {launches}; bit-identical on a second run")
    return {"errs": errs, "launches": launches}


def compose_phase(torch, card: str, gen) -> dict:
    """Phase 17: the parallel axes composed (17a-17d) and K1-K3's rows at
    their new calls: a microbatch's B2 at a model rank's H6 (17a), a model
    rank's H6 at B8 (17d), the ring's block at a model rank's heads (17b,
    B2 S4096 H6) and at a shard of 1024 (17c, B8 H12), Ulysses' whole
    sequence at H3 (17b) and over the (batch, head) pairs (17e, B3 H1)."""
    out = {name: compose_train(torch, name, 17) for name in P17_CASES}
    out["17e ulysses pairs"] = ulysses_pairs(torch, gen)
    ring_b = out["17b tp2 x sp2 ring"]["launches"]
    out["kernels"] = (
        time_training(torch, gen, out["17a pp2 x tp2"]["launches"], heads=6,
                      where="17a (4 steps)", batch=2)
        + time_training(torch, gen, out["17d moe x tp2"]["launches"], heads=6,
                        where="17d (4 steps)")
        + time_training(torch, gen, out["17b tp2 x sp2 ulysses"]["launches"], heads=3,
                        where="17b ulysses (4 steps)", batch=2, seq=8192,
                        label="Ulysses at tp 2 x sp 2: H3, B2, S8192")
        + time_training(torch, gen, out["17e ulysses pairs"]["launches"], heads=1,
                        where="17e (one forward and backward)",
                        batch=P14_B * (P14_H // P17E_TP) // P17E_SP,
                        seq=8192, label="Ulysses pairs at tp 4 x sp 2: H1, B3, S8192")
        + time_seq(torch, gen, ring_b, batch=2, seq=4096, heads=6, where="17b's ring")
        + time_seq(torch, gen, out["17c moe x sp2 ring"]["launches"], batch=8, seq=1024,
                   heads=12, where="17c's ring"))
    log(f"phase 17 on {card}")
    return out


# -- phase 18 ----------------------------------------------------------------
#: 18b: phase 13a's MoE LM over pp 2 with 4 microbatches of B2 (12 layers x
#: 4 microbatches a step each of K1/K2/K3).
P18_PP, P18_MICRO, P18_STEPS = 2, 4, 4
#: 18c's widths: Adafactor factors the 256- and 512-wide kernels.
P18_ADA = dict(vocab_size=256, num_layers=4, num_heads=4, head_dim=64, d_model=256, d_ff=512)


def _microbatch_grads(torch, model, attention_fn, tokens, aux_weight: float,
                      micro: int) -> dict:
    """Step-1 gradients of a flat model on ``micro`` microbatches of
    ``tokens`` in turn, as the pipelined model's loss is: the mean of the
    microbatch losses plus ``aux_weight`` times the mean of their balance
    losses; float32, flat names."""
    from deeplearning_mpi_tpu_torch.models.moe import collect_aux_loss, collecting
    from deeplearning_mpi_tpu_torch.ops.loss import lm_cross_entropy

    model.zero_grad(set_to_none=True)
    for part in tokens.chunk(micro):
        with collecting(model) as sown:
            loss = lm_cross_entropy(model(part, attention_fn=attention_fn), part)
            if sown.aux:
                loss = loss + aux_weight * collect_aux_loss(sown)
            (loss / micro).backward()
    g = {n: p.grad.float() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return g


def pp_moe_train(torch, seed: int) -> dict:
    """18b (:data:`P18_PP`, :data:`P18_MICRO`; the phase docstring)."""
    import numpy as np

    from deeplearning_mpi_tpu_torch.data import SyntheticTokens
    from deeplearning_mpi_tpu_torch.models.pipeline_lm import PipelinedLM
    from deeplearning_mpi_tpu_torch.models.transformer import TransformerLM
    from deeplearning_mpi_tpu_torch.ops.kernels import flash_attention as fa
    from deeplearning_mpi_tpu_torch.parallel.pipeline import LockstepPipe
    from deeplearning_mpi_tpu_torch.train import build_optimizer, create_train_state, make_train_step

    cfg, B, S = moe_config(), 8, 2048
    fn = fa.flash_attention_bhsd
    ds = SyntheticTokens(2 * B, S, vocab_size=cfg.vocab_size, seed=seed)
    rows = np.stack([ds[i]["tokens"] for i in range(2 * B)])
    batches = [{"tokens": torch.from_numpy(rows[i * B:(i + 1) * B]).cuda()}
               for i in (0, 1)] * (P18_STEPS // 2)
    flat = TransformerLM(cfg, dtype=torch.bfloat16, device="cuda").init_weights(seed)
    g_flat = _microbatch_grads(torch, flat, fn, batches[0]["tokens"], MOE_AUX_WEIGHT, P18_MICRO)
    del flat
    torch.cuda.empty_cache()
    model = PipelinedLM(cfg, num_stages=P18_PP, num_microbatches=P18_MICRO,
                        dtype=torch.bfloat16, device="cuda",
                        pipe=LockstepPipe(P18_PP)).init_weights(seed)
    init = {n: p.detach().clone() for n, p in model.named_parameters()}
    g = _model_grads(torch, model, fn, batches[0]["tokens"], MOE_AUX_WEIGHT)
    rel = {n: float((g[n] - w).norm() / w.norm().clamp(min=1e-30)) for n, w in g_flat.items()}
    worst = max(rel, key=rel.get)
    log(f"18b MoE pp {P18_PP} x {P18_MICRO} microbatches vs the flat MoE flash step over the "
        f"same microbatches, step-1 grads (B{B} S{S}, {len(rel)} tensors): relative L2 error "
        f"max {rel[worst]:.3e} ({worst}), median {sorted(rel.values())[len(rel) // 2]:.3e} "
        "(tol 5e-2)")
    require(rel[worst] <= 5e-2, f"18b: grads differ from the flat step: {worst} {rel[worst]}")
    del g, g_flat
    torch.cuda.empty_cache()
    expect = cfg.num_layers * P18_MICRO

    def run(steps: int, profile: bool = False):
        with torch.no_grad():
            for n, p in model.named_parameters():
                p.copy_(init[n])
        state = create_train_state(model, build_optimizer("adam", 3e-4, clip_norm=1.0),
                                   attention_fn=fn)
        step = make_train_step("lm", aux_weight=MOE_AUX_WEIGHT)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_counts(fa)
        losses, times = [], []
        for batch in batches[:steps]:
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(float(metrics["loss"]))
        launches = _kernel_counts(fa)
        prof = (device_profile(torch, lambda: step(state, batches[-1]), "18b profile (one step)")
                if profile else None)
        return state, losses, times, launches, prof

    state, losses, _, _, _ = run(2)
    first = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    state, again, _, _, _ = run(2)
    same = again == losses and all(torch.equal(p, first[n])
                                   for n, p in state.model.named_parameters())
    require(same, f"18b: a second run differs (losses {losses} vs {again})")
    del first
    state, losses, times, launches, prof = run(P18_STEPS, profile=True)
    peak = torch.cuda.max_memory_allocated()
    step_s = sorted(times[1:])[len(times[1:]) // 2]
    result = {"grads_rel_l2_max": rel[worst], "grads_worst": worst, "losses": losses,
              "step_times_s": times, "step_s_median": step_s, "tokens_per_s": B * S / step_s,
              "max_memory_allocated": peak, "launches": launches, "second_run_bitwise": same,
              "profile": prof}
    log(f"18b: losses {[round(x, 4) for x in losses]}, step median {1e3 * step_s:.2f} ms "
        f"(steps 2-{P18_STEPS}), {result['tokens_per_s']:.0f} tokens/s, max_memory_allocated "
        f"{peak / 2**30:.2f} GiB, launches {launches} (expected {expect} a step each), busy "
        f"{100 * prof['busy_share']:.2f}%; a second run bit-identical")
    require(all(np.isfinite(losses)), f"18b: non-finite loss {losses}")
    require(np.mean(losses[-3:]) < losses[0], f"18b: the loss did not fall: {losses}")
    require(all(n == expect * P18_STEPS for n in launches.values()),
            f"18b: expected {expect * P18_STEPS} launches of each kernel, got {launches}")
    del state, model, init
    torch.cuda.empty_cache()
    return result


def adafactor_card_vs_cpu(torch, seed: int) -> dict:
    """18c (:data:`P18_ADA`; the phase docstring)."""
    import numpy as np

    from deeplearning_mpi_tpu_torch.models.convert import flat_from_stacked
    from deeplearning_mpi_tpu_torch.models.pipeline_lm import PipelinedLM
    from deeplearning_mpi_tpu_torch.models.transformer import TransformerConfig, TransformerLM
    from deeplearning_mpi_tpu_torch.ops.kernels import flash_attention as fa
    from deeplearning_mpi_tpu_torch.ops.loss import lm_cross_entropy
    from deeplearning_mpi_tpu_torch.parallel.leaves import reducer as leaf_reducer
    from deeplearning_mpi_tpu_torch.parallel.pipeline import LockstepPipe
    from deeplearning_mpi_tpu_torch.parallel.tensor_parallel import LockstepTP
    from deeplearning_mpi_tpu_torch.train import build_optimizer, create_train_state, make_train_step

    cfg = TransformerConfig(**P18_ADA)
    tokens = torch.from_numpy(np.random.default_rng(seed).integers(0, 256, (4, 256)))

    def whole(model, tree):
        layout = getattr(model, "layout", None) or getattr(model, "tp_layout", None)
        tree = layout.gather(tree)
        return {n: t.detach().cpu().double() for n, t in (
            flat_from_stacked(tree) if hasattr(model, "pipe_layout") else tree).items()}

    def build(kind, device):
        if kind == "tp":
            return TransformerLM(cfg, dtype=torch.float32, device=device,
                                 tp=LockstepTP(2, device)).init_weights(seed)
        return PipelinedLM(cfg, num_stages=2, num_microbatches=2, dtype=torch.float32,
                           device=device, pipe=LockstepPipe(2)).init_weights(seed)

    def run(kind, device):
        model = build(kind, device)
        t = tokens.to(device)
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        model.zero_grad(set_to_none=True)
        lm_cross_entropy(model(t, attention_fn=fa.flash_attention_bhsd), t).backward()
        grads = {n: p.grad for n, p in model.named_parameters()}
        model.zero_grad(set_to_none=True)
        state = create_train_state(model, build_optimizer("adafactor", 1e-3, clip_norm=1.0),
                                   attention_fn=fa.flash_attention_bhsd)
        state, metrics = make_train_step("lm")(state, {"tokens": t})
        delta = {n: p.detach() - before[n] for n, p in model.named_parameters()}
        return float(metrics["loss"]), model, grads, delta

    def cpu_update(kind, grads):
        """The CPU's Adafactor update (the same split leaves) of the card's
        gradients: a gradient element near 0 sets an unfactored leaf's step
        to ``lr * sign(g)``, so the step is compared on the same gradients."""
        model = build(kind, "cpu")
        state = create_train_state(model, build_optimizer("adafactor", 1e-3, clip_norm=1.0))
        params = {n: p.detach() for n, p in model.named_parameters()}
        updates, _ = state.tx.update({n: g.cpu() for n, g in grads.items()}, state.opt_state,
                                     params, shards=state.shards, leaves=leaf_reducer(model))
        return whole(model, updates)

    out = {}
    for kind in ("tp", "pp"):
        loss_gpu, model_gpu, g_gpu, d_gpu = run(kind, "cuda")
        loss_cpu, model_cpu, g_cpu, _ = run(kind, "cpu")
        d_cpu = cpu_update(kind, g_gpu)
        g_gpu, g_cpu = whole(model_gpu, g_gpu), whole(model_cpu, g_cpu)
        d_gpu = whole(model_gpu, d_gpu)
        rel = lambda a, b: float((a - b).norm() / b.norm().clamp(min=1e-30))  # noqa: E731
        g_rel = {n: rel(g_gpu[n], g) for n, g in g_cpu.items()}
        d_rel = {n: rel(d_gpu[n], d) for n, d in d_cpu.items()}
        gw, dw = max(g_rel, key=g_rel.get), max(d_rel, key=d_rel.get)
        loss_rel = abs(loss_gpu - loss_cpu) / abs(loss_cpu)
        label = "LockstepTP(2)" if kind == "tp" else "LockstepPipe(2)"
        log(f"18c adafactor over {label} card vs CPU (4 layers, d_model 256, d_ff 512, float32, "
            f"TF32 off): loss {loss_gpu:.6f} vs {loss_cpu:.6f} ({loss_rel:.2e}, tol 1e-4), worst "
            f"gradient {g_rel[gw]:.3e} ({gw}, tol 1e-4), worst step delta against the CPU's "
            f"update of the card's gradients {d_rel[dw]:.3e} ({dw}, tol 1e-3)")
        require(loss_rel <= 1e-4 and g_rel[gw] <= 1e-4 and d_rel[dw] <= 1e-3,
                f"18c {kind}: card differs from CPU: loss {loss_rel}, {gw} {g_rel[gw]}, "
                f"{dw} {d_rel[dw]}")
        out[kind] = {"loss_rel": loss_rel, "grads_rel_l2_max": g_rel[gw], "grads_worst": gw,
                     "delta_rel_l2_max": d_rel[dw], "delta_worst": dw}
        del model_gpu, model_cpu
    return out


def completed_phase(torch, card: str, gen, seed: int) -> dict:
    """Phase 18: the refusal that stands (18a), the MoE LM through the
    stages (18b), Adafactor over split leaves (18c), and K1-K3's rows at
    18b's microbatch call."""
    out = {"refusal": pp_seq_refusal(), "pp_moe": pp_moe_train(torch, seed)}
    out["adafactor"] = adafactor_card_vs_cpu(torch, seed)
    out["kernels"] = time_training(torch, gen, out["pp_moe"]["launches"],
                                   where=f"18b ({P18_STEPS} steps)", batch=8 // P18_MICRO)
    log(f"phase 18 on {card}")
    return out


# -- phase 19 ----------------------------------------------------------------
#: 19a's run: the 110M widths at phase 8's shape through ``cli.train_lm``;
#: 72 sequences leave 65 to train on, 8 steps of B8.
P19_STEPS, P19_SEQUENCES = 8, 72
#: histogram statistics a registry snapshot appends to an instrument's name
_HIST_STATS = re.compile(r"_(count|mean|p50|p95|max)$")


def canonical_record(rec: dict, *, instruments: bool = False) -> list[str]:
    """What keeps ``rec`` from being a canonical telemetry record: the
    ``{"ts": float, "kind": str, ...}`` shape with flat JSON scalar values;
    with ``instruments`` (a registry snapshot: ``run_summary``,
    ``serve_summary``) every other key an instrument of the schema
    (``telemetry/schema.py``), a histogram's by its base name."""
    from deeplearning_mpi_tpu_torch.telemetry.schema import is_canonical

    bad = []
    if not isinstance(rec.get("ts"), (int, float)) or not isinstance(rec.get("kind"), str):
        bad.append("ts/kind")
    for k, v in rec.items():
        if not isinstance(v, (str, int, float, bool, type(None))):
            bad.append(f"{k} (a {type(v).__name__})")
        elif instruments and k not in ("ts", "kind") and not (
                is_canonical(k) or is_canonical(_HIST_STATS.sub("", k))):
            bad.append(f"{k} (not in the schema)")
    return bad


def _read_jsonl(path: str) -> list[dict]:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def profiled_kernels(trace_path: str) -> dict:
    """K1 / K2 / K3 launches in a ``torch.profiler`` Chrome trace, by their
    C++ names: ``fwd_kernel`` (K1); ``bwd_kernel<..., false>`` or
    ``dq_kernel`` (K2, after its ``delta_kernel``); ``bwd_kernel<...,
    true>`` or ``dkv_kernel`` (K3)."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    counts = {"K1": 0, "K2": 0, "K3": 0, "delta": 0}
    names = set()
    for e in events:
        if e.get("cat") != "kernel":
            continue
        name = e.get("name", "")
        if re.search(r"\bfwd_kernel<", name):
            counts["K1"] += 1
        elif re.search(r"\bdq_kernel<", name):
            counts["K2"] += 1
        elif re.search(r"\bdkv_kernel<", name):
            counts["K3"] += 1
        elif re.search(r"\bbwd_kernel<", name):
            counts["K3" if re.search(r"bwd_kernel<[^()]*(\btrue\b|\(bool\)1)", name) else "K2"] += 1
        elif re.search(r"\bdelta_kernel<", name):
            counts["delta"] += 1
        else:
            continue
        names.add(name)
    counts["names"] = sorted(names)
    return counts


def telemetry_cli(torch, card: str) -> dict:
    """19a: ``cli.train_lm`` at the 110M widths (vocab 256) in bf16, B8
    S2048, flash, 8 steps, with ``--metrics_dir --profile_dir --log_dir
    --metrics_every 1``, over NCCL at world size 1 in this process."""
    import shutil
    import tempfile

    from deeplearning_mpi_tpu_torch.cli import train_lm
    from deeplearning_mpi_tpu_torch.ops.kernels import flash_attention as fa

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="phase19-", dir=os.path.join(ROOT, "build"))
    try:
        dirs = {k: os.path.join(work, k) for k in ("metrics", "profile", "log")}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_counts(fa)
        t0 = time.perf_counter()
        rc = train_lm.main([
            "--device", "cuda", "--attention", "flash", "--dtype", "bfloat16",
            "--num_layers", "12", "--d_model", "768", "--num_heads", "12", "--head_dim", "64",
            "--d_ff", "2048", "--seq_len", "2048", "--batch_size", "8",
            "--train_sequences", str(P19_SEQUENCES), "--num_epochs", "1",
            "--metrics_dir", dirs["metrics"], "--profile_dir", dirs["profile"],
            "--log_dir", dirs["log"], "--metrics_every", "1",
            "--coordinator", f"file://{os.path.join(work, 'rdzv')}", "--num_processes", "1",
            "--process_id", "0"])
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        launches = _kernel_counts(fa)
        require(rc == 0, f"19a: train_lm exited {rc}")
        records = _read_jsonl(os.path.join(dirs["metrics"], "metrics.jsonl"))
        kinds = [r["kind"] for r in records]
        bad = {i: canonical_record(r, instruments=r["kind"].endswith("_summary"))
               for i, r in enumerate(records)}
        bad = {i: b for i, b in bad.items() if b}
        require(not bad, f"19a: records not canonical: {bad}")
        require(kinds == ["step"] * P19_STEPS + ["epoch", "run_summary"],
                f"19a: record kinds {kinds}")
        epoch = records[P19_STEPS]
        want = ("steps_timed", "step_ms_p50", "step_ms_p90", "step_ms_p95", "step_ms_max",
                "items_per_s", "items_per_s_per_device", "mfu", "hbm_bytes_in_use",
                "hbm_bytes_limit", "hbm_utilization", "hbm_peak_bytes")
        missing = [k for k in want if not isinstance(epoch.get(k), (int, float))]
        require(not missing, f"19a: the epoch record lacks {missing}: {epoch}")
        require(epoch["hbm_peak_bytes"] == peak,
                f"19a: hbm_peak_bytes {epoch['hbm_peak_bytes']} != max_memory_allocated {peak}")
        sidecars = [f for f in os.listdir(dirs["log"]) if f.endswith(".metrics.jsonl")]
        require(len(sidecars) == 1 and _read_jsonl(os.path.join(dirs["log"], sidecars[0]))
                == records, f"19a: the run log's sidecar differs from metrics.jsonl: {sidecars}")
        traces = sorted(os.listdir(dirs["profile"]))
        require(len(traces) == 1, f"19a: expected one profiler trace, got {traces}")
        prof = profiled_kernels(os.path.join(dirs["profile"], traces[0]))
        steps = 6 - 3  # Trainer.PROFILE_STEPS
        per_step = {k: prof[k] / steps for k in ("K1", "K2", "K3", "delta")}
        log(f"19a train_lm telemetry [{card}]: rc 0 in {wall:.1f}s, records {len(records)} "
            f"({P19_STEPS} step, epoch, run_summary), all canonical; epoch: step_ms_p50 "
            f"{epoch['step_ms_p50']:.2f}, items_per_s {epoch['items_per_s']:.2f}, mfu "
            f"{100 * epoch['mfu']:.2f}%, comm_bytes_per_step {epoch['comm_bytes_per_step']}, "
            f"hbm_peak_bytes {epoch['hbm_peak_bytes']:.0f} == max_memory_allocated {peak}; "
            f"launches {launches}")
        log(f"19a profiler trace {traces[0]} ({os.path.getsize(os.path.join(dirs['profile'], traces[0]))} "
            f"bytes): per profiled step {per_step} over {steps} steps; names {prof['names']}")
        require(all(per_step[k] == 12 for k in ("K1", "K2", "K3")),
                f"19a: expected K1/K2/K3 12 a profiled step, got {per_step}")
        # 12 a train step each, and K1 12 more for the eval's one batch (7
        # sequences, padded to 8).
        want_launches = {"K1": 12 * (P19_STEPS + 1), "K2": 12 * P19_STEPS, "K3": 12 * P19_STEPS}
        require(launches == want_launches,
                f"19a: expected launches {want_launches}, got {launches}")
        return {"wall_s": wall, "records": len(records), "epoch": epoch, "peak": peak,
                "profile": {k: v for k, v in prof.items() if k != "names"},
                "launches": launches}
    finally:
        shutil.rmtree(work, ignore_errors=True)


class _MarkedLoader:
    """Pre-built card batches; at each step's fetch it notes how many
    synchronizing calls the sync-debug warnings have counted so far."""

    def __init__(self, batches, caught) -> None:
        self.batches, self.caught, self.marks = batches, caught, []

    def epoch(self, epoch: int):
        self.marks = []
        for batch in self.batches:
            self.marks.append(len(self.caught))
            yield batch
        self.marks.append(len(self.caught))


def telemetry_syncs(torch, card: str, seed: int) -> dict:
    """19b: phase 8's train step (110M, bf16, B8 S2048, flash) through the
    ``Trainer`` with the registry's per-step records off (``metrics_every
    0``) and on (``metrics_every 1``); the ``StepTimer`` is on in both, as
    the reference's default. The synchronizing calls each step makes are
    counted under ``torch.cuda.set_sync_debug_mode("warn")``: they must be
    the same in both. Then with a span recorder, the phases sum to the
    epoch's duration."""
    import tempfile
    import warnings

    from deeplearning_mpi_tpu_torch.data import Loader, SyntheticTokens
    from deeplearning_mpi_tpu_torch.models.transformer import TransformerConfig, TransformerLM
    from deeplearning_mpi_tpu_torch.ops.kernels import flash_attention as fa
    from deeplearning_mpi_tpu_torch.telemetry import InMemorySink, MetricsRegistry, SpanRecorder
    from deeplearning_mpi_tpu_torch.telemetry.spans import load_trace_file
    from deeplearning_mpi_tpu_torch.train import Trainer, build_optimizer, create_train_state

    cfg = TransformerConfig()
    B, S, steps = 8, 2048, 6
    model = TransformerLM(cfg, dtype=torch.bfloat16, device="cuda").init_weights(seed)
    loader = Loader(SyntheticTokens(B * steps, S, vocab_size=cfg.vocab_size, seed=seed), B,
                    shuffle=False, device="cuda")
    batches = list(loader.epoch(0))
    state = create_train_state(model, build_optimizer("adam", 3e-4, clip_norm=1.0),
                               attention_fn=fa.flash_attention_bhsd)
    out = {}
    for arm, every in (("off", 0), ("on", 1)):
        sink = InMemorySink()
        trainer = Trainer(state, "lm", log=lambda msg: None, metrics=MetricsRegistry([sink]),
                          metrics_every=every)
        trainer.run_epoch(_MarkedLoader(batches[:2], []), 0)  # warm
        sink.records.clear()
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            marked = _MarkedLoader(batches, caught)
            torch.cuda.set_sync_debug_mode("warn")
            try:
                stats = trainer.run_epoch(marked, 1)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        state = trainer.state
        syncs = [b - a for a, b in zip(marked.marks, marked.marks[1:])]
        out[arm] = {"syncs_per_step": syncs, "epoch_end_syncs": len(caught) - marked.marks[-1],
                    "step_ms_p50": stats["step_ms_p50"], "duration_s": stats["duration_s"],
                    "step_records": sum(r["kind"] == "step" for r in sink.records),
                    "sync_sites": sorted({str(w.message)[:120] for w in caught})}
        log(f"19b registry {arm} (metrics_every {every}) [{card}]: synchronizing calls a step "
            f"{syncs} (expected 0 each), at the epoch's end {out[arm]['epoch_end_syncs']}; "
            "step_ms_p50 "
            f"{stats['step_ms_p50']:.2f} ms (StepTimer, one window of {steps} steps); "
            f"{out[arm]['step_records']} step records; sites {out[arm]['sync_sites']}")
    require(out["on"]["syncs_per_step"] == out["off"]["syncs_per_step"],
            f"19b: the registry changed the syncs a step: {out}")
    # Adam's bias correction took host floats to the card (2 syncs a step
    # before the compiler layer's slice); now the step makes none.
    require(not any(out["on"]["syncs_per_step"]) and not any(out["off"]["syncs_per_step"]),
            f"19b: expected 0 synchronizing calls a step, got {out}")
    out["sync_stacks"] = sync_stacks(torch, trainer, batches[0])
    require(out["on"]["step_records"] == steps and out["off"]["step_records"] == 0,
            f"19b: step records {out['on']['step_records']} / {out['off']['step_records']}")
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tdir:
        tracer = SpanRecorder(os.path.join(tdir, "trace_trainer.jsonl"), proc="trainer")
        trainer = Trainer(state, "lm", log=lambda msg: None, tracer=tracer)
        stats = trainer.run_epoch(_MarkedLoader(batches, []), 2)
        tracer.close()
        phases = {k: v for k, v in stats.items() if k.startswith("phase_")}
        total = sum(phases.values())
        _, spans = load_trace_file(tracer.path)
        names = [s["name"] for s in spans if s.get("kind") == "span"]
    log(f"19b traced [{card}]: phases {phases} sum {total:.6f} s, duration_s "
        f"{stats['duration_s']:.6f} s; {len(names)} spans")
    require(abs(total - stats["duration_s"]) <= 1e-9 * stats["duration_s"],
            f"19b: phases sum {total} != duration {stats['duration_s']}")
    require(names.count("compute") == steps, f"19b: spans {names}")
    out["traced"] = {"phases": phases, "duration_s": stats["duration_s"]}
    return out


def sync_stacks(torch, trainer, batch) -> list[str]:
    """Where one train step synchronizes: the port's innermost Python frame
    of each warning ``set_sync_debug_mode("warn")`` raises in it."""
    import traceback
    import warnings

    sites = []

    def show(message, *args, **kwargs):
        frames = [f for f in traceback.extract_stack()[:-1]
                  if "deeplearning_mpi_tpu_torch" in f.filename]
        where = f"{frames[-1].filename.split('deeplearning_mpi_tpu_torch/')[-1]}:{frames[-1].lineno} " \
                f"{frames[-1].line}" if frames else "outside the port"
        sites.append(where)

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            trainer.state, _ = trainer.train_step(trainer.state, batch)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    log(f"19b the train step's synchronizing calls: {sites}")
    return sites


def telemetry_serve(torch, card: str, seed: int) -> dict:
    """19c: phase 5's engine (the 110M model, f32, 8 Poisson requests) with
    a registry and a span recorder: every stream equal to offline greedy,
    8 TTFT and 8 TPOT observations, the registry's counters equal to
    ``engine.counters``, each request's queue + prefill + decode spans
    tiling its arrival to finish within 1%; then ``serve_lm --selftest
    --metrics_file`` writes canonical records."""
    import tempfile

    from deeplearning_mpi_tpu_torch.cli import serve_lm
    from deeplearning_mpi_tpu_torch.cli.serve_lm import offline_greedy, replay
    from deeplearning_mpi_tpu_torch.models.transformer import TransformerConfig, TransformerLM
    from deeplearning_mpi_tpu_torch.serving import EngineConfig, ServingEngine
    from deeplearning_mpi_tpu_torch.telemetry import MetricsRegistry, SpanRecorder
    from deeplearning_mpi_tpu_torch.telemetry.schema import METRICS
    from deeplearning_mpi_tpu_torch.telemetry.spans import load_trace_file, span_tree

    cfg = TransformerConfig()
    model = TransformerLM(cfg, dtype=torch.float32, device="cuda").init_weights(seed)
    entries = serve_trace(cfg.vocab_size, seed)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tdir:
        registry = MetricsRegistry()
        tracer = SpanRecorder(os.path.join(tdir, "trace_engine.jsonl"), proc="engine",
                              registry=registry)
        engine = ServingEngine(model, EngineConfig(**SERVE_ENGINE), registry=registry,
                               tracer=tracer)
        reqs, wall_s = replay(engine, entries)
        tracer.close()
        _, records = load_trace_file(tracer.path)
        metrics_file = os.path.join(tdir, "serve.jsonl")
        rc = serve_lm.main(["--selftest", "--device", "cuda", "--metrics_file", metrics_file])
        serve_records = _read_jsonl(metrics_file) if os.path.exists(metrics_file) else []
    expects = [offline_greedy(model, r.prompt, r.max_new_tokens, None) for r in reqs]
    streams_equal(model, reqs, expects, "19c")
    snap = registry.snapshot()
    counters = engine.counters
    hist = {h: snap.get(f"{h}_count") for h in ("serve_ttft_s", "serve_tpot_s")}
    # Every engine counter equals the registry's (0 where the registry has
    # none), and every serving counter the registry holds is an engine one.
    differ = {k: (v, snap.get(k, 0.0)) for k, v in counters.items() if snap.get(k, 0.0) != v}
    missing = [k for k in snap if k.startswith(("serve_", "spec_")) and k not in counters
               and METRICS.get(k.split("{")[0], ("",))[0] == "counter"]
    by_sid, children, orphans = span_tree(records)
    worst = 0.0
    for root in (s for s in by_sid.values() if s["name"] == "request"):
        parts = {c["name"]: c["t1"] - c["t0"] for c in children.get(root["sid"], [])}
        total = root["t1"] - root["t0"]
        gap = abs(sum(parts.get(p, 0.0) for p in ("queue", "prefill", "decode")) - total)
        worst = max(worst, gap / total)
    n_roots = sum(s["name"] == "request" for s in by_sid.values())
    bad = {i: canonical_record(r, instruments=r["kind"].endswith("_summary"))
           for i, r in enumerate(serve_records)}
    bad = {i: b for i, b in bad.items() if b}
    log(f"19c engine telemetry [{card}]: {len(reqs)} streams equal offline greedy in "
        f"{wall_s:.2f}s; ttft/tpot counts {hist}; counters {dict(counters)}; differing "
        f"{differ}, registry-only {missing}; {n_roots} request spans, {len(orphans)} orphans, "
        f"worst phase-tiling gap {100 * worst:.4f}% of the request")
    require(hist == {"serve_ttft_s": 8.0, "serve_tpot_s": 8.0}, f"19c: histogram counts {hist}")
    require(not differ and not missing, f"19c: registry vs engine.counters: {differ} {missing}")
    require(n_roots == len(reqs) and not orphans, f"19c: {n_roots} request spans, {orphans}")
    require(worst <= 0.01, f"19c: a request's phases leave {100 * worst:.3f}% of it")
    log(f"19c serve_lm --selftest --metrics_file: rc {rc}, {len(serve_records)} records "
        f"({[r['kind'] for r in serve_records]}), not canonical: {bad}")
    require(rc == 0 and serve_records and not bad,
            f"19c: serve_lm --metrics_file rc {rc}, records {serve_records}, {bad}")
    return {"ttft_p50_s": snap.get("serve_ttft_s_p50"), "tpot_p50_s": snap.get("serve_tpot_s_p50"),
            "counters": dict(counters), "worst_tiling_gap": worst,
            "serve_summary": serve_records[-1]}


def telemetry_phase(torch, card: str, seed: int) -> dict:
    """Phase 19: the telemetry through the trainer CLI (19a), the sync
    count with the registry off and on and the traced phases (19b), and
    the serving engine's instruments and spans (19c)."""
    out = {"cli": telemetry_cli(torch, card)}
    torch.cuda.empty_cache()
    out["syncs"] = telemetry_syncs(torch, card, seed)
    torch.cuda.empty_cache()
    out["serve"] = telemetry_serve(torch, card, seed)
    return out


# -- phase 20 ----------------------------------------------------------------
#: 20a: phase 8's step, captured against eager, over this many steps.
P20_STEPS = 6
#: 20c: the tuned step's shape (cli.autotune --step, then train_lm
#: --tuned_step at this batch and sequence length).
P20_STEP_SHAPE = (8, 256)


def _state_tensors(state) -> dict:
    """Every tensor a train step updates, by name: parameters, optimizer
    state (``count`` included), EMA."""
    out = {f"param/{n}": p.detach() for n, p in state.model.named_parameters()}

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
            else:
                out[f"{prefix}{k}"] = v

    walk(state.opt_state, "opt/")
    walk(state.ema_params or {}, "ema/")
    return out


def _syncs_in(torch, fn) -> list[str]:
    """The synchronizing calls ``fn`` makes, by
    ``torch.cuda.set_sync_debug_mode("warn")``."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    # The mode's own notice ("... is a prototype feature ...") is no sync.
    return [str(w.message)[:120] for w in caught if "prototype" not in str(w.message)]


def _gemm_probe(torch) -> dict:
    """Diagnostic, run only when 20a's arms differ: one bf16 GEMM at the
    step's MLP shape, eager against captured, bitwise or not (does cuBLAS
    pick another algorithm under capture?)."""
    x = torch.randn(8 * 2048, 768, device="cuda", dtype=torch.bfloat16)
    w = torch.randn(2048, 768, device="cuda", dtype=torch.bfloat16)
    eager = torch.nn.functional.linear(x, w)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        torch.nn.functional.linear(x, w)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = torch.nn.functional.linear(x, w)
    graph.replay()
    torch.cuda.synchronize()
    return {"bitwise": bool(torch.equal(out, eager)),
            "max_abs": float((out.float() - eager.float()).abs().max())}


def captured_step(torch, card: str, seed: int) -> dict:
    """20a: phase 8's step (the 110M model, bf16, B8 S2048, flash, Adam
    3e-4 with clip 1.0) through a ``Trainer``, eager and captured
    (``Trainer.warmup``: one CUDA graph of the whole step), from the same
    weights over the same :data:`P20_STEPS` batches: losses, parameters,
    Adam moments and ``count`` bitwise equal; the state after warmup
    bitwise the state before; captures flat after warmup; K1/K2/K3 12 a
    step each, counted through the replays; 0 synchronizing calls in an
    eager and in a replayed step. Then the tiny MoE LM (f32) the same way
    over 3 steps, and ``tiny`` under remat ``dots``. Step medians and
    busy shares reported, no bar."""
    from deeplearning_mpi_tpu_torch.compiler import aot
    from deeplearning_mpi_tpu_torch.data import Loader, SyntheticTokens
    from deeplearning_mpi_tpu_torch.models.transformer import TransformerConfig, TransformerLM
    from deeplearning_mpi_tpu_torch.ops.kernels import flash_attention as fa
    from deeplearning_mpi_tpu_torch.telemetry import InMemorySink, MetricsRegistry
    from deeplearning_mpi_tpu_torch.train import Trainer, build_optimizer, create_train_state

    cfg = TransformerConfig()
    B, S, steps = 8, 2048, P20_STEPS
    model = TransformerLM(cfg, dtype=torch.bfloat16, device="cuda").init_weights(seed)
    init = {n: p.detach().clone() for n, p in model.named_parameters()}
    loader = Loader(SyntheticTokens(B * steps, S, vocab_size=cfg.vocab_size, seed=seed), B,
                    shuffle=False, device="cuda")
    batches = list(loader.epoch(0))
    out: dict = {"card": card}
    arms = {}
    for arm in ("eager", "captured"):
        with torch.no_grad():
            for n, p in model.named_parameters():
                p.copy_(init[n])
        sink = InMemorySink()
        trainer = Trainer(create_train_state(model, build_optimizer("adam", 3e-4, clip_norm=1.0),
                                             attention_fn=fa.flash_attention_bhsd),
                          "lm", log=log, metrics=MetricsRegistry([sink]))
        if arm == "captured":
            before = {n: t.clone() for n, t in _state_tensors(trainer.state).items()}
            captures = aot.CapturedProgram.total_captures
            trainer.warmup(batches[0])
            after = _state_tensors(trainer.state)
            require(all(torch.equal(after[n], t) for n, t in before.items()),
                    "20a: the state after warmup differs from the state before")
            require(aot.CapturedProgram.total_captures == captures + 1,
                    f"20a: warmup made {aot.CapturedProgram.total_captures - captures} captures")
            del before, after
            captures = aot.CapturedProgram.total_captures
        _zero_counts(fa)
        losses, times = [], []
        for batch in batches:
            t0 = time.perf_counter()
            trainer.state, metrics = trainer.train_step(trainer.state, batch)
            trainer.metrics.record_step(len(losses), metrics)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(metrics["loss"])
        launches = _kernel_counts(fa)
        losses = [float(x) for x in losses]
        records = [r["loss"] for r in trainer.metrics.flush_steps()]
        require(records == losses, f"20a {arm}: the registry's step records {records} are not "
                f"the step losses {losses}")
        def one_step():
            trainer.state, _ = trainer.train_step(trainer.state, batches[-1])

        syncs = _syncs_in(torch, one_step)
        prof = device_profile(torch, one_step, f"20a {arm} profile (one step)")
        median = sorted(times[1:])[len(times[1:]) // 2]
        arms[arm] = {"losses": losses, "step_times_s": times, "step_s_median": median,
                     "launches": launches, "syncs_per_step": len(syncs), "sync_sites": syncs,
                     "busy_share": prof["busy_share"], "trainer": trainer}
        log(f"20a {arm} [{card}]: losses {[round(x, 4) for x in losses]}, step median "
            f"{1e3 * median:.2f} ms (steps 2-{steps}), busy {100 * prof['busy_share']:.2f}%, "
            f"launches {launches}, synchronizing calls in one step {len(syncs)} {syncs}")
        require(all(n == 12 * steps for n in launches.values()),
                f"20a {arm}: expected {12 * steps} launches of each kernel, got {launches}")
        require(not syncs, f"20a {arm}: the step synchronizes: {syncs}")
        if arm == "captured":
            require(aot.CapturedProgram.total_captures == captures,
                    "20a: captures rose after warmup")
            require(trainer.train_step.fallback_calls == 0, "20a: a captured step fell back")
        if arm == "eager":
            # The same starting point for the captured arm: the eager arm's
            # state is compared after both ran, so keep it off the model.
            arms[arm]["state"] = {n: t.clone() for n, t in _state_tensors(trainer.state).items()}
            del arms[arm]["trainer"]
    # Both arms ran 6 steps plus the sync and profile steps: 8 updates each.
    eager, captured = arms["eager"]["state"], _state_tensors(arms["captured"]["trainer"].state)
    differ = [n for n, t in eager.items() if not torch.equal(captured[n], t)]
    same_losses = arms["eager"]["losses"] == arms["captured"]["losses"]
    if differ or not same_losses:
        probe = _gemm_probe(torch)
        log(f"20a: captured differs from eager: losses equal {same_losses}, {len(differ)} "
            f"tensors differ (first {differ[:3]}); GEMM probe eager vs captured {probe}")
        out["probe"] = probe
    require(same_losses and not differ, "20a: the captured step is not bitwise the eager step")
    log(f"20a [{card}]: captured == eager bitwise over {steps} steps (+2): losses, "
        f"{sum(n.startswith('param/') for n in eager)} parameters, Adam moments and count; "
        f"step median {1e3 * arms['captured']['step_s_median']:.2f} ms captured / "
        f"{1e3 * arms['eager']['step_s_median']:.2f} ms eager, busy "
        f"{100 * arms['captured']['busy_share']:.2f}% / {100 * arms['eager']['busy_share']:.2f}%")
    for arm in arms.values():
        arm.pop("trainer", None)
        arm.pop("state", None)
    out.update(arms)
    del eager, captured, init, model
    torch.cuda.empty_cache()
    out.update(captured_small(torch, card, seed))
    return out


def captured_small(torch, card: str, seed: int) -> dict:
    """20a, the other step forms: ``tiny_moe`` (8 experts) and ``tiny``
    under remat ``dots`` (checkpointed blocks), f32 (TF32 off), 3 steps
    each, captured against eager: losses and every updated tensor
    bitwise; neither step (the routing, the recompute) synchronizes."""
    import numpy as np

    from deeplearning_mpi_tpu_torch.models.transformer import TransformerConfig, TransformerLM
    from deeplearning_mpi_tpu_torch.train import Trainer, build_optimizer, create_train_state

    out = {}
    for name, cfg, remat in (("moe", TransformerConfig.tiny_moe(8), "none"),
                             ("remat_dots", TransformerConfig.tiny(), "dots")):
        rng = np.random.default_rng(seed)
        batches = [{"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 64))).cuda()}
                   for _ in range(3)]
        runs = {}
        for warm in (False, True):
            model = TransformerLM(cfg, dtype=torch.float32, device="cuda",
                                  remat=remat).init_weights(seed)
            trainer = Trainer(create_train_state(model, build_optimizer("adam", 1e-3,
                                                                        clip_norm=1.0)),
                              "lm", aux_weight=MOE_AUX_WEIGHT if cfg.moe_experts else 0.0,
                              log=lambda msg: None)
            if warm:
                trainer.warmup(batches[0])
            losses = []
            for batch in batches:
                trainer.state, metrics = trainer.train_step(trainer.state, batch)
                losses.append(float(metrics["loss"]))

            def one_step():
                trainer.state, _ = trainer.train_step(trainer.state, batches[0])

            syncs = _syncs_in(torch, one_step)
            runs[warm] = (losses, _state_tensors(trainer.state), syncs)
        same = runs[True][0] == runs[False][0] and all(
            torch.equal(t, runs[False][1][n]) for n, t in runs[True][1].items())
        log(f"20a {name} (f32) [{card}]: captured == eager bitwise over 3 steps (+1): {same}; "
            f"losses {runs[True][0]}; synchronizing calls a step {len(runs[True][2])} "
            f"captured, {len(runs[False][2])} eager")
        require(same, f"20a {name}: captured {runs[True][0]} differs from eager "
                f"{runs[False][0]}")
        require(not runs[True][2] and not runs[False][2],
                f"20a {name}: the step synchronizes: {runs[True][2]} {runs[False][2]}")
        out[name] = {"losses": runs[True][0], "bitwise": same}
    return out


def kernel_cache_check(torch, card: str) -> dict:
    """20b: a fresh process loads every kernel through the build cache with
    0 builds and a hit a library; the manifest verifies."""
    from deeplearning_mpi_tpu_torch.compiler.cache import kernel_cache
    from deeplearning_mpi_tpu_torch.ops.kernels import _build

    code = ("import json, sys\n"
            f"sys.path.insert(0, {ROOT!r})\n"
            "from deeplearning_mpi_tpu_torch.compiler.cache import kernel_cache\n"
            "from deeplearning_mpi_tpu_torch.ops.kernels import _build\n"
            "for name in _build._EXPORTS:\n"
            "    _build.load(name)\n"
            "print(json.dumps(kernel_cache().stats()))\n")
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    require(res.returncode == 0, f"20b: the fresh process failed: {res.stderr[-2000:]}")
    stats = json.loads(res.stdout.strip().splitlines()[-1])
    bad = kernel_cache().verify()
    n = len(_build._EXPORTS)
    log(f"20b kernel cache [{card}]: a fresh process loaded {n} libraries in "
        f"{time.perf_counter() - t0:.1f}s: {stats}; verify() -> {bad}")
    require(stats["builds"] == 0 and stats["misses"] == 0 and stats["hits"] == n,
            f"20b: expected {n} hits and no build, got {stats}")
    require(bad == [], f"20b: libraries failed their digests: {bad}")
    return {"fresh_process": stats, "verify": bad}


def tuning_db_check(torch, card: str) -> dict:
    """20c: ``cli.autotune --step`` at :data:`P20_STEP_SHAPE` and
    ``--spec_k 1`` at the tiny config on the card; ``train_lm --tuned_step
    --aot_warmup`` at that shape applies the DB's schedule over 2 steps
    (one CUDA graph); ``serve_lm --tuning_db --selftest`` takes the DB's
    ``spec_k`` for the tiny config and a 1-layer draft."""
    import contextlib
    import io
    import shutil
    import tempfile

    from deeplearning_mpi_tpu_torch.cli import autotune, serve_lm, train_lm

    def cli(main, argv):
        buf, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(err):
            rc = main(argv)
        return rc, buf.getvalue(), err.getvalue()

    work = tempfile.mkdtemp(prefix="phase20-", dir=os.path.join(ROOT, "build"))
    db = os.path.join(work, "tuned.json")
    out: dict = {"card": card}
    try:
        batch, seq = P20_STEP_SHAPE
        t0 = time.perf_counter()
        rc, _, err = cli(autotune.main, ["--db", db, "--step", f"{batch}x{seq}", "--verify_steps",
                                         "3", "--repeats", "2", "--spec_k", "1"])
        lines = [ln for ln in err.splitlines() if ln.startswith(("step ", "spec_k "))]
        log(f"20c cli.autotune --step {batch}x{seq} --spec_k 1 [{card}]: exit {rc} in "
            f"{time.perf_counter() - t0:.1f}s: {lines}")
        require(rc == 0 and len(lines) == 2, f"20c: cli.autotune exited {rc}: {err[-2000:]}")
        entries = json.load(open(db))["entries"]
        step_key = f"step|lm|{batch}x{seq}|1|float32|cuda"
        require(step_key in entries, f"20c: no {step_key} in {sorted(entries)}")
        out["step"] = entries[step_key]
        spec = [e for k, e in entries.items() if k.startswith("spec_k|")]
        require(len(spec) == 1, f"20c: spec_k entries {sorted(entries)}")
        out["spec_k"] = spec[0]
        rc, text, err = cli(train_lm.main, [
            "--device", "cuda", "--attention", "flash", "--num_layers", "2", "--num_heads", "2",
            "--head_dim", "64", "--d_model", "128", "--d_ff", "256", "--seq_len", str(seq),
            "--batch_size", str(batch), "--train_sequences", str(2 * batch + 2),
            "--num_epochs", "1", "--tuned_step", db, "--aot_warmup"])
        applied = [ln for ln in text.splitlines() if "tuned step schedule" in ln or "warmup:" in ln
                   or ln.startswith("Epoch")]
        log(f"20c train_lm --tuned_step --aot_warmup [{card}]: exit {rc}: {applied}")
        require(rc == 0 and any(f"{out['step']['params']}" in ln for ln in applied)
                and any("one CUDA graph" in ln for ln in applied),
                f"20c: train_lm did not apply the schedule under a capture: {text[-2000:]} "
                f"{err[-2000:]}")
        tiny = ["--num_layers", "2", "--num_heads", "4", "--head_dim", "8", "--d_model", "32",
                "--d_ff", "64"]
        rc, _, err = cli(serve_lm.main, ["--selftest", "--device", "cuda", *tiny,
                                         "--draft_layers", "1", "--tuning_db", db])
        want = f"spec_k from tuning DB: {out['spec_k']['params']['spec_k']}"
        log(f"20c serve_lm --tuning_db --selftest [{card}]: exit {rc}: "
            f"{[ln for ln in err.splitlines() if 'spec_k' in ln or 'selftest' in ln]}")
        require(rc == 0 and want in err, f"20c: serve_lm exited {rc}: {err[-2000:]}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


def compiler_phase(torch, card: str, seed: int) -> dict:
    """Phase 20: the compiler layer (20a-20c)."""
    out = {"captured": captured_step(torch, card, seed)}
    torch.cuda.empty_cache()
    out["cache"] = kernel_cache_check(torch, card)
    out["tuning"] = tuning_db_check(torch, card)
    return out


# -- phase 21 ----------------------------------------------------------------
#: 21a's plan on 3 epochs of 2 steps: the kill 1 step into epoch 2, epoch
#: 1's save corrupted at commit, batch 1's assembly stalled past the
#: watchdog's deadline. The restart walks past epoch 1 to epoch 0 and trains
#: epochs 1-2 again: 2 + 2 + 1 + 2 + 2 = 9 steps, history [0, 1, 1, 2].
P21_PLAN = "kill@step:5,corrupt_ckpt@epoch:1,loader_stall@batch:1"
P21_EPOCHS, P21_STEPS_A, P21_RUN_STEPS = 3, 2, 9
#: 21b: 4 of the 12 blocks; 3 epochs of 4 steps, the spike at step 9 (past
#: the policy's 8-step warmup, epoch 2), rolled back to the pinned epoch 1.
P21B_LAYERS, P21B_STEPS, P21B_SPIKE = 4, 4, 9
P21_EMA = 0.999


class _TimedCheckpointer:
    """A ``Checkpointer`` whose saves and verified restores are timed
    (synchronised first: the state copies to the host)."""

    def __init__(self, torch, ck) -> None:
        self.torch, self.ck, self.save_s, self.restore_s = torch, ck, [], []

    def __getattr__(self, name):
        return getattr(self.ck, name)

    def _timed(self, into, fn, *args, **kw):
        if self.torch.cuda.is_available():
            self.torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        into.append(time.perf_counter() - t0)
        return out

    def save(self, state, *, epoch):
        return self._timed(self.save_s, self.ck.save, state, epoch=epoch)

    def restore_verified(self, template):
        return self._timed(self.restore_s, self.ck.restore_verified, template)

    def rollback_to_last_good(self, template):
        return self._timed(self.restore_s, self.ck.rollback_to_last_good, template)


def _p21_run(torch, cfg, seed: int, *, batch: int, seq: int, steps: int, device: str,
             plan: str | None = None, work: str | None = None, guardrails: bool = False,
             warm: bool = True, stall_s: float = 1.0, ema: bool = True) -> dict:
    """One supervised run through ``utils.config.execute`` (``max_restarts``
    2): the LM of ``cfg`` from ``seed``'s weights, bf16 on the card (f32
    elsewhere), flash, Adam 3e-4 with clip 1.0, an EMA when ``ema``;
    ``steps`` batches an
    epoch of seeded sequences; warmed (``Trainer.warmup``) first when
    ``warm``. With ``plan``: the injector on the checkpointer (in ``work``)
    and the trainer, the train loader under the watchdog (a 0.5 s deadline
    against a ``stall_s`` stall). Returns the trainer, its books, the
    launches after warmup, the checkpoint timings and the seconds."""
    from deeplearning_mpi_tpu_torch.compiler import aot
    from deeplearning_mpi_tpu_torch.data import Loader, SyntheticTokens
    from deeplearning_mpi_tpu_torch.models.transformer import TransformerLM
    from deeplearning_mpi_tpu_torch.ops.kernels import flash_attention as fa
    from deeplearning_mpi_tpu_torch.resilience import (
        ChaosInjector,
        FaultPlan,
        GuardrailPolicy,
        ResilientLoader,
    )
    from deeplearning_mpi_tpu_torch.telemetry import InMemorySink, MetricsRegistry
    from deeplearning_mpi_tpu_torch.train import Trainer, build_optimizer, create_train_state
    from deeplearning_mpi_tpu_torch.train.checkpoint import Checkpointer
    from deeplearning_mpi_tpu_torch.utils import config

    dtype = torch.bfloat16 if device == "cuda" else torch.float32

    def factory():
        model = TransformerLM(cfg, dtype=dtype, device=device).init_weights(seed)
        return create_train_state(model, build_optimizer("adam", 3e-4, clip_norm=1.0),
                                  attention_fn=fa.flash_attention_bhsd, ema=ema)

    chaos = None if plan is None else ChaosInjector(FaultPlan.parse(plan), stall_s=stall_s)
    ck = None if work is None else _TimedCheckpointer(torch, Checkpointer(work, max_to_keep=5,
                                                                         chaos=chaos))
    sink = InMemorySink()
    notes = []
    trainer = Trainer(factory(), "lm", eval_every=1, ema_decay=P21_EMA if ema else 0.0,
                      log=notes.append,
                      checkpointer=ck, chaos=chaos, metrics=MetricsRegistry([sink]),
                      guardrails=GuardrailPolicy() if guardrails else None)
    loader = Loader(SyntheticTokens(batch * steps, seq, vocab_size=cfg.vocab_size, seed=seed),
                    batch, shuffle=True, seed=seed, device=device)
    t0 = time.perf_counter()
    if warm:
        trainer.warmup(next(iter(loader.epoch(0))))
    warm_s = time.perf_counter() - t0
    if chaos is not None:
        chaos.bind_registry(trainer.metrics)
        loader = ResilientLoader(loader, chaos=chaos, batch_timeout_s=0.5, backoff_s=0.01,
                                 logger=trainer)
    args = argparse.Namespace(num_epochs=P21_EPOCHS, max_restarts=2, eval_only=False,
                              restart_delay_s=0.0)
    captures = aot.CapturedProgram.total_captures
    _zero_counts(fa)
    t0 = time.perf_counter()
    config.execute(config.Run(args, trainer, loader, None, 0, factory))
    if device == "cuda":
        torch.cuda.synchronize()
    return {"trainer": trainer, "chaos": chaos, "summary": [r for r in sink.records
                                                           if r["kind"] == "run_summary"][-1],
            "launches": _kernel_counts(fa), "seconds": time.perf_counter() - t0,
            "warmup_s": warm_s, "recaptures": aot.CapturedProgram.total_captures - captures,
            "fallback_calls": getattr(trainer.train_step, "fallback_calls", None),
            "save_s": [] if ck is None else ck.save_s,
            "restore_s": [] if ck is None else ck.restore_s, "notes": notes}


def _p21_free(torch) -> None:
    """Free what dropped trainers held: a trainer, its warmed program and
    its captured step refer to each other, so their CUDA graph pools go
    only with a collection, before the cache is emptied."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def _p21_books(run: dict) -> tuple:
    s = run["summary"]
    return (s.get("fault_injected_total"), s.get("recovery_total"), s.get("rollback_total"))


def _p21_same_state(torch, want: dict, trainer) -> list[str]:
    """The names of the tensors (parameters, optimizer state with ``count``,
    EMA) of ``trainer``'s state that differ from ``want`` (a snapshot)."""
    got = _state_tensors(trainer.state)
    require(set(got) == set(want), "21: the two states hold other tensors")
    return [n for n, t in got.items() if not torch.equal(t, want[n])]


def _p21_snapshot(trainer) -> dict:
    return {n: t.clone() for n, t in _state_tensors(trainer.state).items()}


def resilience_drill(torch, card: str, seed: int, *, device: str = "cuda", cfg=None,
                     batch: int = 8, seq: int = 2048) -> dict:
    """21a: phase 8's step (the 110M model, bf16, B8 S2048, flash, Adam 3e-4
    with clip 1.0, and an EMA) warmed into one CUDA graph, then 3 epochs of
    2 steps under ``utils.config.execute`` with ``max_restarts`` 2 and
    :data:`P21_PLAN`; then the same run without a plan (and without a
    checkpointer). Hard bars: parameters, Adam moments, ``count`` and EMA
    bitwise the unfaulted run's; history [0, 1, 1, 2] with each epoch's loss
    the unfaulted epoch's; books 3 = 2 + 1; K1/K2/K3 12 a step over the 9
    steps run (the replays included), no capture after warmup, no step
    eager (``fallback_calls`` 0), the held model the one restored into.
    The 110M save and verified-restore seconds are reported."""
    import shutil
    import tempfile

    from deeplearning_mpi_tpu_torch.models.transformer import TransformerConfig

    cfg = cfg or TransformerConfig()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="phase21-", dir=os.path.join(ROOT, "build"))
    _p21_free(torch)
    try:
        # 23a: the faulted run's saves under the sanitizer's donation canary.
        with _Sanitized() as san:
            faulted = _p21_run(torch, cfg, seed, batch=batch, seq=seq, steps=P21_STEPS_A,
                               device=device, plan=P21_PLAN, work=os.path.join(work, "ck"))
            canary = {"canaries": san.canaries, "saves": len(faulted["save_s"]),
                      "trips": san.trips()}
        nbytes = sum(f.stat().st_size for f in
                     (faulted["trainer"].checkpointer.step_dir(2)).iterdir())
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(f"23a canary over 21a's saves [{card}]: {canary['canaries']} canaries for "
        f"{canary['saves']} saves of the 110M captured state, trips {canary['trips']}")
    require(canary["canaries"] == canary["saves"] > 0 and not canary["trips"],
            f"23a: the canary over 21a's saves: {canary}")
    ft = faulted.pop("trainer")
    programs = list(ft.train_step.programs.values())
    require(all(p.model is ft.state.model for p in programs),
            "21a: the trainer's model is not the one its captured step holds")
    recovered, history = _p21_snapshot(ft), [h["epoch"] for h in ft.history]
    losses = [(h["epoch"], h["loss"]) for h in ft.history]
    chaos = ft.chaos
    fallback_calls = ft.train_step.fallback_calls
    del ft, programs
    _p21_free(torch)
    clean = _p21_run(torch, cfg, seed, batch=batch, seq=seq, steps=P21_STEPS_A, device=device)
    ct = clean.pop("trainer")
    differ = _p21_same_state(torch, recovered, ct)
    clean_loss = {h["epoch"]: h["loss"] for h in ct.history}
    del ct, recovered
    layers = cfg.num_layers
    want = layers * P21_RUN_STEPS
    out = {"card": card, "history": history, "losses": losses, "clean_losses": clean_loss,
           "books": _p21_books(faulted), "launches": faulted["launches"],
           "clean_launches": clean["launches"], "fallback_calls": fallback_calls,
           "recaptures": faulted["recaptures"], "seconds": faulted["seconds"],
           "clean_seconds": clean["seconds"], "warmup_s": faulted["warmup_s"],
           "save_s": faulted["save_s"], "restore_s": faulted["restore_s"],
           "checkpoint_bytes": nbytes, "tensors_differing": differ,
           "chaos": chaos.summary(), "canary": canary}
    log(f"21a drill [{card}]: history {history}, books {out['books']} ({out['chaos']}), "
        f"launches {out['launches']} (expected {want} each: {P21_RUN_STEPS} steps), fallback "
        f"calls {out['fallback_calls']}, captures after warmup {out['recaptures']}; faulted run "
        f"{out['seconds']:.2f}s, unfaulted {out['clean_seconds']:.2f}s, warmup "
        f"{out['warmup_s']:.2f}s; saves {[round(x, 3) for x in out['save_s']]}s, restores "
        f"{[round(x, 3) for x in out['restore_s']]}s of {nbytes} bytes; "
        f"{len(differ)} tensors differ from the unfaulted run's")
    require(history == [0, 1, 1, 2], f"21a: history {history}")
    require(all(loss == clean_loss[e] for e, loss in losses),
            f"21a: epoch losses {losses} against the unfaulted {clean_loss}")
    require(not differ, f"21a: the recovered state differs from the unfaulted run's: {differ[:5]}")
    require(out["books"] == (3, 2, 1), f"21a: books {out['books']}")
    require(chaos.balanced() and not chaos.unrecovered(), f"21a: {out['chaos']}")
    if device == "cuda":
        require(all(n == want for n in out["launches"].values()),
                f"21a: expected {want} launches of each kernel, got {out['launches']}")
    require(out["fallback_calls"] == 0 and out["recaptures"] == 0,
            f"21a: a clean step ran eager ({out['fallback_calls']}) or a capture was made "
            f"({out['recaptures']})")
    del faulted, clean
    _p21_free(torch)
    return out


class _Snapshots:
    """A loader over pre-built batches that clones the trainer's tensors at
    each fetch: the state before each step (and after the last)."""

    def __init__(self, batches, trainer_ref) -> None:
        self.batches, self.trainer_ref, self.states = batches, trainer_ref, []

    def _snap(self):
        self.states.append({n: t.clone() for n, t in _state_tensors(
            self.trainer_ref[0].state).items()})

    def epoch(self, epoch: int):
        for batch in self.batches:
            self._snap()
            yield batch
        self._snap()


def guard_drill(torch, card: str, seed: int, *, device: str = "cuda", cfg=None,
                batch: int = 8, seq: int = 2048) -> dict:
    """21b: phase 8's widths at :data:`P21B_LAYERS` of the 12 blocks. A
    ``nan_grad@step:1`` on a warmed trainer: the state after step 1 bitwise
    the state before it, the epoch's mean over the finite steps, one
    recovery booked (the poisoned batch carries a mask the clean ones lack:
    it takes the eager step, ``fallback_calls`` 1). Under ``guardrails``, a
    ``loss_spike`` at step :data:`P21B_SPIKE`: judged poisoned, rolled back
    to the pinned epoch 1 and replayed bitwise onto the unfaulted run, one
    rollback in the books. Then the synchronizing calls a step of the
    chaos-hooked loop, guardrails off (0) and on (the policy's reads)."""
    import dataclasses
    import shutil
    import tempfile

    from deeplearning_mpi_tpu_torch.data import Loader, SyntheticTokens
    from deeplearning_mpi_tpu_torch.models.transformer import TransformerConfig, TransformerLM
    from deeplearning_mpi_tpu_torch.ops.kernels import flash_attention as fa
    from deeplearning_mpi_tpu_torch.resilience import ChaosInjector, FaultPlan, GuardrailPolicy
    from deeplearning_mpi_tpu_torch.train import Trainer, build_optimizer, create_train_state

    cfg = cfg or dataclasses.replace(TransformerConfig(), num_layers=P21B_LAYERS)
    dtype = torch.bfloat16 if device == "cuda" else torch.float32
    out: dict = {"card": card, "layers": cfg.num_layers}

    def state():
        model = TransformerLM(cfg, dtype=dtype, device=device).init_weights(seed)
        return create_train_state(model, build_optimizer("adam", 3e-4, clip_norm=1.0),
                                  attention_fn=fa.flash_attention_bhsd)

    batches = list(Loader(SyntheticTokens(3 * batch, seq, vocab_size=cfg.vocab_size, seed=seed),
                          batch, shuffle=False, device=device).epoch(0))
    # The NaN step, warmed.
    chaos = ChaosInjector(FaultPlan.parse("nan_grad@step:1"))
    ref = [None]
    trainer = Trainer(state(), "lm", log=lambda m: None, chaos=chaos)
    ref[0] = trainer
    trainer.warmup(batches[0])
    chaos.bind_registry(trainer.metrics)
    snaps = _Snapshots(batches, ref)
    stats = trainer.run_epoch(snaps, 0)
    before, after = snaps.states[1], snaps.states[2]
    skipped = [n for n, t in before.items() if not torch.equal(t, after[n])]
    moved = [n for n, t in snaps.states[2].items() if not torch.equal(t, snaps.states[3][n])]
    out["nan"] = {"changed_by_step_1": skipped, "epoch_loss": stats["loss"],
                  "fallback_calls": trainer.train_step.fallback_calls,
                  "books": (chaos.counts().get("fault_injected_total"),
                            chaos.counts().get("recovery_total"))}
    log(f"21b nan_grad@step:1 [{card}, {cfg.num_layers} blocks]: {len(skipped)} tensors changed "
        f"by the poisoned step (0 expected), {len(moved)} by step 2; epoch loss "
        f"{stats['loss']:.4f} over the finite steps; books {out['nan']['books']}; fallback calls "
        f"{out['nan']['fallback_calls']} (the poisoned batch, its mask a key the clean ones lack)")
    require(not skipped, f"21b: the NaN step changed {skipped[:5]}")
    require(moved and math.isfinite(stats["loss"]), "21b: the next step did not train")
    require(out["nan"]["books"] == (1.0, 1.0) and chaos.balanced(), f"21b: {chaos.summary()}")
    require(out["nan"]["fallback_calls"] == 1, "21b: the poisoned batch did not take the eager step")
    del trainer, snaps, ref, before, after
    _p21_free(torch)
    # The loss spike under guardrails, warmed, against the unfaulted run.
    work = tempfile.mkdtemp(prefix="phase21b-", dir=os.path.join(ROOT, "build"))
    try:
        spiked = _p21_run(torch, cfg, seed, batch=batch, seq=seq, steps=P21B_STEPS,
                          device=device, plan=f"loss_spike@step:{P21B_SPIKE}",
                          work=os.path.join(work, "ck"), guardrails=True, ema=False)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    st = spiked.pop("trainer")
    replayed, history, spike_chaos = _p21_snapshot(st), [h["epoch"] for h in st.history], st.chaos
    snap = st.metrics.snapshot()
    del st
    _p21_free(torch)
    clean = _p21_run(torch, cfg, seed, batch=batch, seq=seq, steps=P21B_STEPS, device=device,
                     guardrails=True, ema=False)
    differ = _p21_same_state(torch, replayed, clean.pop("trainer"))
    del replayed
    _p21_free(torch)
    out["spike"] = {"history": history, "books": _p21_books(spiked),
                    "guard_rollback_total": snap.get("guard_rollback_total"),
                    "guard_poisoned_total": snap.get("guard_poisoned_total"),
                    "fallback_calls": spiked["fallback_calls"], "seconds": spiked["seconds"],
                    "restore_s": spiked["restore_s"], "tensors_differing": differ}
    log(f"21b loss_spike@step:{P21B_SPIKE} under guardrails [{card}]: history "
        f"{out['spike']['history']}, books {out['spike']['books']}, poisoned "
        f"{out['spike']['guard_poisoned_total']}, rollbacks {out['spike']['guard_rollback_total']}"
        f", fallback calls {out['spike']['fallback_calls']}; {len(differ)} tensors differ from "
        f"the unfaulted run's; {spiked['seconds']:.2f}s")
    require(out["spike"]["history"] == [0, 1, 2], f"21b: history {out['spike']['history']}")
    require(not differ, f"21b: the replay differs from the unfaulted run: {differ[:5]}")
    require(out["spike"]["books"] == (1, 0, 1) and spike_chaos.balanced(),
            f"21b: books {out['spike']['books']}")
    require(out["spike"]["guard_rollback_total"] == 1, "21b: no rollback booked")
    require(out["spike"]["fallback_calls"] == 1,
            "21b: the spiked batch (its __loss_scale__ key) did not take the eager step alone")
    del spiked, clean
    # Syncs a step: chaos hooks on, guardrails off and on.
    syncs = {}
    for arm, policy in (("off", None), ("on", GuardrailPolicy())):
        trainer = Trainer(state(), "lm", log=lambda m: None, metrics_every=0,
                          chaos=ChaosInjector(FaultPlan.parse("kill@step:999")),
                          guardrails=policy)
        trainer.run_epoch(_MarkedLoader(batches[:1], []), 0)  # warm
        if device != "cuda":
            syncs[arm] = None
            continue
        import warnings

        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            marked = _MarkedLoader(batches, caught)
            torch.cuda.set_sync_debug_mode("warn")
            try:
                trainer.run_epoch(marked, 1)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        # The mode's own notice is no sync (20a).
        real = [i for i, w in enumerate(caught) if "prototype" not in str(w.message)]
        syncs[arm] = [sum(a <= i < b for i in real) for a, b in zip(marked.marks, marked.marks[1:])]
        del trainer
        _p21_free(torch)
    out["syncs_per_step"] = syncs
    log(f"21b synchronizing calls a step with the chaos hooks [{card}]: guardrails off "
        f"{syncs['off']} (19b's count: 0), on {syncs['on']} (the policy's loss / finite / "
        "grad-norm reads)")
    if device == "cuda":
        require(not any(syncs["off"]), f"21b: guardrails off, syncs a step {syncs['off']}")
    return out


#: 21c's model and shape: phase 19's widths (the 110M model's at vocab 256,
#: bf16, B8 S2048, flash) at 4 of the 12 blocks, 17 train sequences (2
#: steps an epoch), 2 epochs.
P21C_LAYERS = 4
P21C_FLAGS = ["--attention", "flash", "--dtype", "bfloat16", "--num_layers", str(P21C_LAYERS),
              "--d_model", "768", "--num_heads", "12", "--head_dim", "64", "--d_ff", "2048",
              "--seq_len", "2048", "--batch_size", "8", "--train_sequences", "18",
              "--num_epochs", "2"]


def resilience_cli(torch, card: str, *, device: str = "cuda", model_flags=None) -> dict:
    """21c: ``cli.train_lm`` at phase 19's widths (the 110M model's at vocab
    256, bf16, B8 S2048, flash) and :data:`P21C_LAYERS` of its 12 blocks,
    2 epochs of 2 steps, with ``--chaos
    kill@step:3,corrupt_ckpt@epoch:0 --max_restarts 2 --log_dir --aot_warmup``:
    exit 0, the kill restarted from a fresh init (the only save corrupt), the
    run summary's books balanced (2 = 1 + 1), ``heartbeat.json`` at the
    final step (3 before the kill, 4 after); then ``--chaos
    serve_crash@step:1`` exits 1 naming the training workload."""
    import contextlib
    import io
    import shutil
    import tempfile

    from deeplearning_mpi_tpu_torch.cli import train_lm
    from deeplearning_mpi_tpu_torch.ops.kernels import flash_attention as fa
    from deeplearning_mpi_tpu_torch.resilience import Heartbeat

    flags = ["--device", device] + (model_flags or P21C_FLAGS)
    work = tempfile.mkdtemp(prefix="phase21c-", dir=os.path.join(ROOT, "build"))
    try:
        dirs = {k: os.path.join(work, k) for k in ("model", "log", "metrics")}
        _zero_counts(fa)
        text = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(text):
            rc = train_lm.main(flags + [
                "--chaos", "kill@step:3,corrupt_ckpt@epoch:0", "--max_restarts", "2",
                "--restart_delay_s", "0", "--model_dir", dirs["model"], "--log_dir", dirs["log"],
                "--metrics_dir", dirs["metrics"], "--aot_warmup"])
        seconds = time.perf_counter() - t0
        launches = _kernel_counts(fa)
        lines = [ln for ln in text.getvalue().splitlines()
                 if ln.startswith(("chaos:", "checkpoint epoch", "restart:", "training failed",
                                   "auto-resume", "warmup:"))]
        for line in lines:
            log(f"21c | {line}")
        require(rc == 0, f"21c: train_lm --chaos exited {rc}")
        summary = [r for r in _read_jsonl(os.path.join(dirs["metrics"], "metrics.jsonl"))
                   if r["kind"] == "run_summary"][-1]
        books = (summary.get("fault_injected_total"), summary.get("recovery_total"),
                 summary.get("rollback_total"))
        beat = Heartbeat.read(os.path.join(dirs["log"], "heartbeat.json")) or {}
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            refused = train_lm.main(flags + ["--chaos", "serve_crash@step:1"])
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out = {"rc": rc, "seconds": seconds, "books": books, "heartbeat_step": beat.get("step"),
           "launches": launches, "refused_rc": refused, "refusal": err.getvalue().strip()}
    log(f"21c train_lm --chaos kill@step:3,corrupt_ckpt@epoch:0 --max_restarts 2 --aot_warmup "
        f"[{card}]: exit {rc} in {seconds:.1f}s, run_summary books {books}, heartbeat step "
        f"{out['heartbeat_step']}, launches {launches}; --chaos serve_crash@step:1 exit "
        f"{refused}: {out['refusal'][:160]}")
    require(books == (2, 1, 1), f"21c: run_summary books {books}")
    require(out["heartbeat_step"] == 7, f"21c: heartbeat step {out['heartbeat_step']}")
    if device == "cuda":  # the warmup's 3 eager steps and the 7 steps run, a layer each
        require(launches["K2"] == launches["K3"] == P21C_LAYERS * 10 <= launches["K1"],
                f"21c: launches {launches}")
    require(refused == 1 and "training workload" in out["refusal"],
            f"21c: serve_crash refused with {refused}: {out['refusal']}")
    return out


def resilience_phase(torch, card: str, seed: int) -> dict:
    """Phase 21: the resilience layer (21a-21c), each after a collection
    (the earlier phases' dropped trainers hold CUDA graph pools)."""
    out = {"drill": resilience_drill(torch, card, seed)}
    out["guard"] = guard_drill(torch, card, seed)
    _p21_free(torch)
    out["cli"] = resilience_cli(torch, card)
    _p21_free(torch)
    return out


# -- phase 22 ----------------------------------------------------------------
#: 22a: two crashes mid-step (after admission and prefill) through phase 5's
#: engine and trace.
P22_CRASH = "serve_crash@step:3,serve_crash@step:9"
#: 22b: the handoff wedged at the pair's step 4.
P22_STALL = "handoff_stall@step:4"
#: 22c/22d: the fleet's replicas at the 110M widths (vocab 256) and 2 of the
#: 12 blocks: a replica process's start (torch, a CUDA context, its warmup)
#: dominates a drill, not its depth.
P22_LAYERS = 2
P22_DEVICE = "cuda"
P22_MODEL = ["--vocab_size", "256", "--num_layers", str(P22_LAYERS), "--num_heads", "12",
             "--head_dim", "64", "--d_model", "768", "--d_ff", "2048"]
#: 22c: the reference drills' plans (``tools/fleet_drill.py``,
#: ``tools/autoscale_drill.py``) through ``serve_lm --selftest``; the trace
#: flags keep requests arriving through the recoveries and the swap.
P22_FLEETS = {
    "kill_hang_swap": ["--replicas", "2", "--chaos", "replica_kill@step:4,replica_hang@step:6",
                       "--swap_at", "8", "--num_requests", "30", "--rate", "1.2"],
    "hedge": ["--replicas", "2", "--hedge_ms", "60", "--chaos", "replica_slow@step:2",
              "--num_requests", "16", "--rate", "3"],
    "autoscale": ["--autoscale", "--min_replicas", "1", "--max_replicas", "3", "--chaos",
                  "load_spike@step:2,scale_during_failure@step:1", "--num_requests", "64",
                  "--rate", "1000", "--max_new_tokens", "32", "--max_queue", "128"],
}


#: 22c-d's runs in lanes that run side by side, each lane's runs one after
#: another (a run is host-bound: mostly replica start-up).
P22_LANES = (("kill_hang_swap",), ("hedge",), ("autoscale",), ("controlplane",))


def _zero_serving(fa, fd) -> None:
    fa.flash_attention_cuda.launches = 0
    fd.flash_decode_cuda.launches = 0


def _serving_counts(fa, fd) -> dict:
    return {"K1": fa.flash_attention_cuda.launches, "K4": fd.flash_decode_cuda.launches}


def serve_crash_drill(torch, model, entries, expects) -> dict:
    """22a: phase 5's engine under ``P22_CRASH``, eager then warmed: every
    stream equal to offline greedy, the books 2 = 2 + 0, requeued work, K1
    and K4 launched by the engine (counts set to 0 just before each run)."""
    from deeplearning_mpi_tpu_torch.cli.serve_lm import replay
    from deeplearning_mpi_tpu_torch.ops.kernels import flash_attention as fa
    from deeplearning_mpi_tpu_torch.ops.kernels import flash_decode as fd
    from deeplearning_mpi_tpu_torch.resilience.faults import ChaosInjector
    from deeplearning_mpi_tpu_torch.serving import EngineConfig, ServingEngine

    out = {}
    for arm in ("eager", "warmed"):
        chaos = ChaosInjector.from_spec(P22_CRASH)
        engine = ServingEngine(model, EngineConfig(**SERVE_ENGINE), chaos=chaos)
        if arm == "warmed":
            engine.warmup()
        captures = engine.captures
        _zero_serving(fa, fd)
        reqs, wall_s = replay(engine, entries)
        torch.cuda.synchronize()
        launches = _serving_counts(fa, fd)
        c = chaos.counts()
        books = (c.get("fault_injected_total", 0), c.get("recovery_total", 0),
                 c.get("rollback_total", 0))
        requeued = engine.counters["serve_requeued_total"]
        log(f"22a {arm}: {wall_s:.2f}s, books {books}, requeued {requeued}, discarded "
            f"{engine.counters['serve_tokens_discarded_total']} tokens, launches {launches}")
        streams_equal(model, reqs, expects, f"22a {arm}")
        require(books == (2, 2, 0) and chaos.balanced(), f"22a {arm}: books {books}")
        require(requeued > 0, f"22a {arm}: the crashes requeued nothing")
        require(launches["K1"] > 0 and launches["K4"] > 0, f"22a {arm}: launches {launches}")
        require(engine.captures == captures, f"22a {arm}: traffic captured a program")
        engine.pool.check()
        require(engine.pool.in_use == 0, f"22a {arm}: pool not drained")
        out[arm] = {"wall_s": wall_s, "books": books, "requeued": requeued,
                    "launches": launches, "captures": engine.captures}
    return out


def disagg_drill(torch, model, entries, expects) -> dict:
    """22b: the disaggregated pair at full depth on phase 5's trace, eager,
    warmed, then warmed with ``P22_STALL``: the streams equal offline
    greedy (and so the colocated engine's, held to the same), the handoffs
    equal the requests with more than one new token (the stall run
    included: it re-prefills nothing), no K4 launch inside a prefill-role
    step and no K1 launch inside a decode-role step (counters read around
    each role's step), the shared pool drained, the books balanced."""
    from deeplearning_mpi_tpu_torch.cli.serve_lm import replay
    from deeplearning_mpi_tpu_torch.ops.kernels import flash_attention as fa
    from deeplearning_mpi_tpu_torch.ops.kernels import flash_decode as fd
    from deeplearning_mpi_tpu_torch.resilience.faults import ChaosInjector
    from deeplearning_mpi_tpu_torch.serving import DisaggregatedEngine, EngineConfig

    out = {}
    for arm, plan in (("eager", None), ("warmed", None), ("warmed stall", P22_STALL)):
        chaos = ChaosInjector.from_spec(plan) if plan else None
        engine = DisaggregatedEngine(model, EngineConfig(**SERVE_ENGINE), chaos=chaos)
        kv = [b.data_ptr() for b in engine.prefill._kvh.bufs]
        if arm != "eager":
            engine.warmup()
        captures = engine.captures
        lanes = {"prefill": {"K1": 0, "K4": 0}, "decode": {"K1": 0, "K4": 0}}

        def counted(role, step):
            def run():
                before = _serving_counts(fa, fd)
                done = step()
                after = _serving_counts(fa, fd)
                for k in lanes[role]:
                    lanes[role][k] += after[k] - before[k]
                return done
            return run

        engine.prefill.step = counted("prefill", engine.prefill.step)
        engine.decode.step = counted("decode", engine.decode.step)
        _zero_serving(fa, fd)
        reqs, wall_s = replay(engine, entries)
        torch.cuda.synchronize()
        launches = _serving_counts(fa, fd)
        crossing = sum(len(r.generated) > 1 for r in reqs)
        c = engine.counters
        log(f"22b {arm}: {wall_s:.2f}s, {c['serve_handoffs_total']} handoffs for {crossing} "
            f"multi-token requests, {c['serve_handoff_stalls_total']} stalled step(s), lanes "
            f"{lanes}, launches {launches}, {engine.captures} captures")
        streams_equal(model, reqs, expects, f"22b {arm}")
        require(c["serve_handoffs_total"] == crossing > 0, f"22b {arm}: handoffs")
        require(lanes["prefill"]["K4"] == 0 and lanes["decode"]["K1"] == 0,
                f"22b {arm}: a role left its lane: {lanes}")
        require(lanes["prefill"]["K1"] > 0 and lanes["decode"]["K4"] > 0,
                f"22b {arm}: a role launched nothing: {lanes}")
        require(engine.captures == captures, f"22b {arm}: traffic captured a program")
        require([b.data_ptr() for b in engine.prefill._kvh.bufs] == kv
                and engine.decode._kvh is engine.prefill._kvh, f"22b {arm}: KV pools moved")
        engine.pool.check()
        require(engine.pool.in_use == 0, f"22b {arm}: pool holds {engine.pool.in_use} blocks")
        if chaos is not None:
            require(chaos.balanced() and c["serve_handoff_stalls_total"] == 1,
                    f"22b {arm}: {chaos.summary()}")
        out[arm] = {"wall_s": wall_s, "handoffs": c["serve_handoffs_total"], "lanes": lanes,
                    "launches": launches, "captures": engine.captures,
                    "stalls": c["serve_handoff_stalls_total"]}
    return out


def _fleet_check(name: str, lines: list[str], fleet_dir: str) -> dict:
    """22c's bars on one ``serve_lm`` fleet run's output and journal."""
    import collections

    from deeplearning_mpi_tpu_torch.resilience.cluster import JOURNAL_FILE, replay_journal

    def get(prefix):
        return next(ln for ln in lines if ln.startswith(prefix))

    workers = json.loads(get("fleet workers: ").split(": ", 1)[1])
    versions = json.loads(get("fleet versions: ").split(": ", 1)[1])
    summary = next(ln for ln in lines if re.match(r"fleet: \d+ completed", ln))
    chaos_line = get("fleet: chaos: ")
    journal = replay_journal(os.path.join(fleet_dir, JOURNAL_FILE))
    done = collections.Counter(r["rid"] for r in journal if r["ev"] == "done")
    # Spawn -> ready-ack of each replica attempt, on the supervisor's clock.
    spawned = {(r["idx"], r["attempt"]): r["t"] for r in journal if r["ev"] == "spawn"}
    ready_s = sorted(round(r["t"] - spawned[(r["idx"], r["attempt"])], 3) for r in journal
                     if r["ev"] == "ready" and (r["idx"], r["attempt"]) in spawned)
    # Where each attempt's start-up went: the worker's stages from its
    # ready ack, the rest (interpreter, imports) spawn -> ready less them.
    startup = []
    for r in journal:
        if r["ev"] == "ready" and (r["idx"], r["attempt"]) in spawned and r.get("startup_s"):
            split = {k: round(v, 3) for k, v in r["startup_s"].items()}
            split["imports"] = round(r["t"] - spawned[(r["idx"], r["attempt"])]
                                     - sum(r["startup_s"].values()), 3)
            startup.append(split)
    recoveries = [float(m.group(1)) for m in (re.search(r"closed \(([0-9.]+)s after", ln)
                                               for ln in lines) if m]
    completed = int(re.match(r"fleet: (\d+) completed", summary).group(1))
    redispatched = int(re.search(r"(\d+) re-dispatched", summary).group(1))
    dropped = int(re.search(r"(\d+) dropped", summary).group(1))
    served = {k: w for k, w in workers.items() if w["served"] > 0}
    require(served and all(w["K1"] > 0 and w["K4"] > 0 for w in served.values()),
            f"22c {name}: a serving worker launched no K1 or K4: {workers}")
    require(set(done.values()) == {1} and len(done) == completed,
            f"22c {name}: not one stream a rid")
    require(dropped == 0 and "UNRECOVERED" not in chaos_line and "never fired" not in chaos_line,
            f"22c {name}: {summary} | {chaos_line}")
    row = {"completed": completed, "redispatched": redispatched, "workers": workers,
           "versions": versions, "chaos": chaos_line, "summary": summary,
           "ready_s": ready_s, "startup_s": startup, "recovery_s": recoveries}
    if name == "kill_hang_swap":
        swap = get("swap: ")
        require(redispatched >= 1, f"22c {name}: nothing re-dispatched")
        require("performed=True" in swap and "compile_flat=True" in swap and "in_place=True" in swap,
                f"22c {name}: {swap}")
        require(set(versions) == {"0", "1"}, f"22c {name}: versions {versions}")
        row["swap"] = swap
    elif name == "hedge":
        row["hedges"] = get("hedges: ")
        require(int(re.search(r"(\d+) fired", row["hedges"]).group(1)) >= 1,
                f"22c {name}: no hedge fired")
    else:
        row["scale"] = get("autoscale: ")
        require(int(re.search(r"(\d+) spawned", row["scale"]).group(1)) >= 1,
                f"22c {name}: no scale-up: {row['scale']}")
        row["calibration"] = fleet_calibration(fleet_dir)  # 23b's inputs
    return row


def _controlplane_check(lines: list[str]) -> dict:
    """22d's bars on ``cli.controlplane_drill``'s report."""
    res = json.loads(next(ln for ln in lines if ln.startswith("controlplane_drill: "))
                     .split(": ", 1)[1])
    served = {k: w for k, w in res["workers"].items() if w["served"] > 0}
    require(res["ok_all"], f"22d: bars {res['bars']}")
    require(res["readopted"] == res["orphans"] >= 2 and res["respawned"] == 0,
            f"22d: readopted {res['readopted']} of {res['orphans']}, respawned {res['respawned']}")
    require(served and all(w["K1"] > 0 and w["K4"] > 0 for w in served.values()),
            f"22d: a serving worker launched no K1 or K4: {res['workers']}")
    return res


def fleet_drills(torch, card: str) -> dict:
    """22c and 22d in ``P22_LANES`` (each run its own processes: a run is
    host-bound, mostly replica start-up): ``serve_lm --selftest``
    on the card at the 110M widths (vocab 256, ``P22_LAYERS`` blocks)
    through each of ``P22_FLEETS``, and ``cli.controlplane_drill``. 22c:
    exit 0 with the CLI's own bit-exact parity, the books balanced, one
    stream a rid (the journal's wins), every worker that served reporting K1
    and K4 launches since its ready ack (its warmup's are not counted); the
    kill / hang run re-dispatched and swapped in place with no capture
    (streams under both versions), the slow one hedged, the autoscaled one
    scaled up with zero drops; each replica's start-up by stage (the ready
    ack's split, the imports the rest of spawn -> ready). 22d: the
    supervisor SIGKILLs itself mid-surge and the restarted incarnation
    re-adopts every live replica with no respawn, the books balance across
    incarnations, every stream equals offline greedy."""
    import shutil
    import tempfile

    work = tempfile.mkdtemp(prefix="phase22c-", dir=os.path.join(ROOT, "build"))
    env = {**os.environ, "DMT_CHAOS_STALL_S": "0.25"}
    runs = {name: [sys.executable, "-m", "deeplearning_mpi_tpu_torch.cli.serve_lm",
                   "--selftest", "--device", P22_DEVICE, *P22_MODEL,
                   "--fleet_dir", os.path.join(work, name), *flags]
            for name, flags in P22_FLEETS.items()}
    runs["controlplane"] = [sys.executable, "-m", "deeplearning_mpi_tpu_torch.cli.controlplane_drill",
                            "--device", P22_DEVICE, "--root", os.path.join(work, "cp"), *P22_MODEL]
    out: dict = {"fleet": {}}
    done: dict = {}

    def lane(names, t0):
        for name in names:
            t_run = time.perf_counter()
            with open(os.path.join(work, f"{name}.log"), "w+") as f:
                proc = subprocess.Popen(runs[name], cwd=ROOT, env=env, stdout=f,
                                        stderr=subprocess.STDOUT, text=True)
                try:
                    proc.wait(timeout=max(1.0, 600 - (time.perf_counter() - t0)))
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()
                f.seek(0)
                done[name] = (proc.returncode, f.read().splitlines(),
                              time.perf_counter() - t_run, time.perf_counter() - t0)

    try:
        t0 = time.perf_counter()
        threads = [threading.Thread(target=lane, args=(names, t0)) for names in P22_LANES]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for names in P22_LANES:
            for name in names:
                rc, lines, seconds, ended = done[name]
                for line in lines:
                    if not line.startswith("fleet: hedge: rid"):
                        log(f"22{'d' if name == 'controlplane' else 'c'} {name} | {line[:400]}")
                require(rc == 0, f"22 {name}: exited {rc}")
                if name == "controlplane":
                    row = out["controlplane"] = _controlplane_check(lines)
                else:
                    row = out["fleet"][name] = _fleet_check(name, lines, os.path.join(work, name))
                row.update(seconds=seconds, ended_s=ended)
                log(f"22 {name} OK in {seconds:.1f}s (ended {ended:.1f}s after the lanes "
                    f"started): spawn -> ready {row.get('ready_s')}; by stage "
                    f"{row.get('startup_s')}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


def k1_chunk_row(torch, launches: int) -> dict:
    """K1 at the engine's prefill-chunk call (``serving.engine.chunk_attention``):
    a 128-row chunk at positions 384-511 over a slot's 1024 page rows, which
    the engine issues as a square ``[1, 512, 12, 64]`` float32 causal call
    with the rows before the chunk zero. The call is held to ``FWD_TOL``
    against its plain version, bit-identical on a second launch, and
    ``chunk_attention``'s rows are held to the masked matmul. The bound and
    SDPA count the chunk's own work: its queries over ``k/v[:start + C]``
    with the offset causal mask. ``launches`` are phase 22's."""
    import torch.nn.functional as F

    from deeplearning_mpi_tpu_torch.ops.attention import dense_attention
    from deeplearning_mpi_tpu_torch.ops.kernels import flash_attention as fa
    from deeplearning_mpi_tpu_torch.serving.engine import chunk_attention

    gen = torch.Generator(device="cuda").manual_seed(22)
    L, H, D, start, C = 1024, 12, 64, 384, 128
    S = start + C
    chunk = torch.randn(1, C, H, D, generator=gen, device="cuda")
    pages_k, pages_v = (torch.randn(1, L, H, D, generator=gen, device="cuda") for _ in range(2))
    q = torch.zeros(1, S, H, D, device="cuda")
    q[:, start:] = chunk
    k, v = pages_k[:, :S], pages_v[:, :S]
    kw = dict(causal=True, window=None, shift=0, return_lse=False, out_dtype=None, layout="bshd")
    got, again = (fa.flash_attention_cuda(q, k, v, **kw) for _ in range(2))
    want = fa.flash_attention_reference(q, k, v, **kw)
    rows = chunk_attention(chunk, pages_k, pages_v, start)
    rows_want = dense_attention(chunk, pages_k, pages_v, causal=True, q_offset=start)
    torch.cuda.synchronize()
    atol, rtol, l2 = FWD_TOL["float32"]
    ok, err, rel = grads_close(got, want, atol, rtol, l2)
    require(torch.equal(got, again), "K1 chunk call: a second launch differs")
    require(ok, f"K1 chunk call: max abs err {err}, rel L2 {rel}")
    rows_ok, rows_err, rows_rel = grads_close(rows, rows_want, atol, rtol, l2)
    require(rows_ok, f"chunk_attention vs the masked matmul: max abs err {rows_err}, "
                     f"rel L2 {rows_rel}")
    # Query row i (position start + i) sees keys 0 .. start + i.
    pairs = H * (C * start + C * (C + 1) // 2)
    flops, nbytes = 4 * D * pairs, (2 * C + 2 * S) * H * D * 4
    qt, kt, vt = chunk.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    mask = (torch.arange(S, device="cuda")[None, :]
            <= start + torch.arange(C, device="cuda")[:, None])
    row = {
        "name": "K1 flash_attention_fwd (f32 prefill chunk, phase 22)", "route": "cuda",
        "source": "deeplearning_mpi_tpu_torch/csrc/flash_attention_fwd.cu",
        "replaces": "deeplearning_mpi_tpu/ops/pallas/flash_attention.py:110",
        "launches": launches, "max_abs_err": err,
        "ms": time_ms(lambda: fa.flash_attention_cuda(q, k, v, **kw)),
        "plain_ms": time_ms(lambda: fa.flash_attention_reference(q, k, v, **kw)),
        "bound_ms": max(flops / PEAK_FLOPS["float32"], nbytes / PEAK_BYTES) * 1e3,
        "bound_by": "operations" if flops / PEAK_FLOPS["float32"] > nbytes / PEAK_BYTES else "bytes",
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)),
        "shape": f"B1 S{S} H{H} D{D} float32 causal call, chunk rows {start}-{S - 1} of {L} pages",
    }
    log(f"time {row['name']} [{row['shape']}]: kernel {row['ms']:.4f} ms, plain "
        f"{row['plain_ms']:.4f} ms, sdpa (chunk over k/v[:{S}], offset mask) "
        f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']}); "
        f"max abs err {err:.3e}, rel L2 {rel:.3e}; chunk rows vs masked matmul {rows_err:.3e}")
    return row


def serving_resilience_phase(torch, card: str, gen, seed: int) -> dict:
    """Phase 22: the serving half of the resilience layer (22a-22d), then
    K1 at the prefill-chunk call and K4 at the serving decode shape with
    phase 22's launches (the in-process engines' and every worker's)."""
    from deeplearning_mpi_tpu_torch.cli.serve_lm import offline_greedy
    from deeplearning_mpi_tpu_torch.models.transformer import TransformerConfig, TransformerLM

    t0 = time.perf_counter()
    cfg = TransformerConfig()
    model = TransformerLM(cfg, dtype=torch.float32, device="cuda").init_weights(seed)
    entries = serve_trace(cfg.vocab_size, seed)
    expects = [offline_greedy(model, e["prompt"], e["max_new"], None) for e in entries]
    # 23a: 22a's engines (eager and warmed) built and run under the sanitizer.
    with _Sanitized() as san:
        out = {"crash": serve_crash_drill(torch, model, entries, expects)}
        out["sanitized"] = {"trips": san.trips(),
                            "mirrored": {k: v for k, v in san.registry.snapshot().items()
                                         if k.startswith("sanitize_") and v}}
    log(f"23a sanitized 22a [{card}]: eager and warmed engines under DMT_SANITIZE=1, streams "
        f"equal offline greedy, launches {[r['launches'] for r in out['crash'].values()]}, "
        f"trips {out['sanitized']['trips']}")
    require(not out["sanitized"]["trips"] and not out["sanitized"]["mirrored"],
            f"23a: 22a's sanitized engines tripped: {out['sanitized']}")
    out["disagg"] = disagg_drill(torch, model, entries, expects)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    log(f"22a-b in {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    out.update(fleet_drills(torch, card))
    log(f"22c-d in {time.perf_counter() - t0:.1f}s")
    counts = {"K1": 0, "K4": 0}
    for run in (*out["crash"].values(), *out["disagg"].values()):
        for k in counts:
            counts[k] += run["launches"][k]
    workers = [w for f in out["fleet"].values() for w in f["workers"].values()]
    workers += list(out["controlplane"]["workers"].values())
    for w in workers:
        for k in counts:
            counts[k] += w[k]
    out["launches"] = counts
    out["kernels"] = [k1_chunk_row(torch, counts["K1"]),
                      k4_row(torch, gen, counts["K4"], serve_fills(), 1024,
                             name="K4 flash_decode (phase 22)")]
    return out


def phase_23(torch, card: str, serving: dict) -> dict:
    """Phase 23's parts that follow phase 22: 23b (the simulator calibrated
    from 22c's autoscaled fleet) and 23a's injections on a fresh engine;
    23a's sanitized 22a and 21a saves ran inside those phases, 23c is phase
    12b, 23d ran before the ``flash_decode`` join."""
    out = {"sim": sim_calibration(card, serving["fleet"]["autoscale"].pop("calibration"))}
    out["injections"] = sanitizer_injections(torch, card)
    return out


# -- phase 23 ----------------------------------------------------------------
#: 23d: the ``.pth`` imports. ResNet-18 at torchvision's widths with a
#: 10-class head (``module.``-prefixed keys, as DDP saves them) and the
#: reference UNet (``out_classes`` 2, its default) against the oracle; a
#: 1-class UNet (what ``train_unet`` builds) for ``--eval_only``.
P23_EVAL_RESNET = ["--synthetic", "--batch_size", "64", "--train_samples", "512",
                   "--torch_padding"]
P23_EVAL_UNET = ["--synthetic", "--batch_size", "8", "--train_samples", "40", "--image_size",
                 "128", "--reference_topology"]
#: 23b: the reference calibration test's band around its measured burst
#: TTFT p50 (``tests/test_sim.py``: 1.5 s < p50 < 21.0 s against ~10.5 s).
P23_RATIO_BAND = (1.5 / 10.5, 21.0 / 10.5)


class _Sanitized:
    """``DMT_SANITIZE=1`` for a block: trips reset first, a registry
    attached; afterwards the variable is removed and the registry detached
    (objects built inside stay sanitized). Counts the donation canaries
    made (``canaries``)."""

    def __enter__(self):
        from deeplearning_mpi_tpu_torch.analysis import sanitizer
        from deeplearning_mpi_tpu_torch.telemetry import MetricsRegistry

        self.sanitizer = sanitizer
        self.registry = MetricsRegistry()
        self.canaries = 0
        self._canary = sanitizer.donation_canary

        def counted(state):
            self.canaries += 1
            return self._canary(state)

        sanitizer.donation_canary = counted
        os.environ["DMT_SANITIZE"] = "1"
        sanitizer.reset_trips()
        sanitizer.attach_registry(self.registry)
        return self

    def trips(self) -> dict:
        return self.sanitizer.trip_counts()

    def __exit__(self, *exc):
        os.environ.pop("DMT_SANITIZE", None)
        self.sanitizer.donation_canary = self._canary
        self.sanitizer.attach_registry(None)
        return False


def sanitizer_injections(torch, card: str, device: str = "cuda") -> dict:
    """23a: ``cli.sanitize_drill`` on the card: a fresh tiny warmed engine
    (captured decode graphs) serves a request with 0 trips, then each
    injection (double free, use after free, refcount underflow, a
    copy-on-write write to a shared block, a capture after warmup, and the
    eager fallback at an uncaptured width; a checkpoint save racing an
    in-place ``add_`` on the hashed tensor) raises, classified, counted
    once and mirrored into the registry."""
    from deeplearning_mpi_tpu_torch.analysis import sanitizer
    from deeplearning_mpi_tpu_torch.cli import sanitize_drill

    t0 = time.perf_counter()
    try:
        d = sanitize_drill.run(device)
    finally:
        os.environ.pop("DMT_SANITIZE", None)
        sanitizer.attach_registry(None)
    trips = d.trips
    sanitizer.reset_trips()
    log(f"23a injections [{card}]: {len(d.injections)} in {time.perf_counter() - t0:.1f}s, "
        f"{ {k: v[0].replace('sanitize_', '') for k, v in d.injections.items()} }, trips {trips}")
    require(not d.failures, f"23a: sanitize drill failed: {d.failures}")
    require(all(after == before + 1 for _, before, after in d.injections.values())
            and len(d.injections) == 7, f"23a: injections {d.injections}")
    require(set(trips) == set(sanitizer.TRIP_CLASSES), f"23a: trip classes {trips}")
    return {"injections": {k: list(v) for k, v in d.injections.items()}, "trips": trips}


def _done_records(fleet_dir: str) -> list[dict]:
    out = []
    for name in sorted(os.listdir(fleet_dir)):
        box = os.path.join(fleet_dir, name, "outbox.jsonl")
        if os.path.isfile(box):
            out += [r for r in _read_jsonl(box) if r.get("op") == "done"]
    return out


def fleet_calibration(fleet_dir: str) -> dict:
    """23b's inputs from phase 22c's ``--autoscale`` run, read before its
    directory goes: the fleet summary's TTFT before any fault (the
    unloaded service time, as the reference calibrates from its drill's
    unloaded p50; the least TTFT served where no request finished before
    the first fault), the workers' TPOT median, every completion's TTFT
    (p50 / p95: the measured side of the bar), the spawn -> ready seconds,
    the scale-ups."""
    import statistics

    from deeplearning_mpi_tpu_torch.resilience.cluster import JOURNAL_FILE, replay_journal

    summary = [r for r in _read_jsonl(os.path.join(fleet_dir, "fleet_metrics.jsonl"))
               if r.get("kind") == "fleet_summary"][-1]
    done = _done_records(fleet_dir)
    ttfts = sorted(float(r["ttft"]) for r in done if r.get("ttft") is not None)
    tpots = [float(r["tpot"]) for r in done if r.get("tpot") is not None]
    journal = replay_journal(os.path.join(fleet_dir, JOURNAL_FILE))
    spawned = {(r["idx"], r["attempt"]): r["t"] for r in journal if r["ev"] == "spawn"}
    ready = sorted(r["t"] - spawned[(r["idx"], r["attempt"])] for r in journal
                   if r["ev"] == "ready" and (r["idx"], r["attempt"]) in spawned)
    unloaded = summary.get("ttft_before_p50")
    return {"ttft_unloaded_s": unloaded if unloaded is not None else ttfts[0],
            "ttft_unloaded_source": "ttft_before_p50" if unloaded is not None else "least TTFT",
            "tpot_p50_s": statistics.median(tpots), "ttfts": ttfts,
            "ttft_p50_s": ttfts[min(int(0.5 * len(ttfts)), len(ttfts) - 1)],
            "ttft_p95_s": ttfts[min(int(0.95 * len(ttfts)), len(ttfts) - 1)],
            "warmup_s": statistics.median(ready), "ready_s": ready,
            "completed": int(summary["completed_total"]), "shed": int(summary["shed_total"]),
            "scale_ups": int(summary.get("scale_spawned", 0))}


def sim_calibration(card: str, measured: dict) -> dict:
    """23b: ``sim.FleetSimulator`` on phase 22c's ``--autoscale`` trace (64
    requests at once, ``--max_queue 128``, the fleet's engine and
    ``AutoscalerConfig``), its ``ServiceModel.from_telemetry`` from that
    run's records (:func:`fleet_calibration`). The reference calibration
    test's bars: 64 completions and 0 sheds in both, a scale-up in each,
    the simulated TTFT p50 within ``P23_RATIO_BAND`` of the measured one.
    The fleet also served the 8 requests of its ``load_spike`` and a
    ``scale_during_failure`` kill, which the simulator does not model (as
    the reference's calibration drill's chaos)."""
    import dataclasses

    from deeplearning_mpi_tpu_torch.cli import serve_lm
    from deeplearning_mpi_tpu_torch.serving import AutoscalerConfig
    from deeplearning_mpi_tpu_torch.sim import FleetSimulator, ServiceModel, SimConfig

    args = serve_lm.build_parser().parse_args(
        ["--selftest", *P22_MODEL, *P22_FLEETS["autoscale"]])
    entries = serve_lm.poisson_trace(args)
    for e in entries:
        e["prompt"] = [int(t) for t in e["prompt"]]
        e.pop("deadline", None)
    mean_prompt = sum(len(e["prompt"]) for e in entries) / len(entries)
    service = ServiceModel.from_telemetry(
        ttft_p50_s=measured["ttft_unloaded_s"], tpot_p50_s=measured["tpot_p50_s"],
        mean_prompt_len=mean_prompt, warmup_s=measured["warmup_s"])
    cfg = SimConfig(
        initial_replicas=args.min_replicas, max_slots=args.max_slots, max_queue=args.max_queue,
        kv_blocks=args.num_blocks, kv_block_size=args.block_size, service=service,
        slo_ttft_s=30.0,
        autoscale=AutoscalerConfig(min_replicas=args.min_replicas,
                                   max_replicas=args.max_replicas))
    t0 = time.perf_counter()
    res = FleetSimulator(cfg).run(entries)
    wall = time.perf_counter() - t0
    p50, p95 = res.ttft_quantile(0.5), res.ttft_quantile(0.95)
    ratio = p50 / measured["ttft_p50_s"]
    out = {"card": card, "service": dataclasses.asdict(service), "requests": len(entries),
           "sim": res.summary(), "sim_ttft_p50_s": p50, "sim_ttft_p95_s": p95,
           "measured": {k: v for k, v in measured.items() if k != "ttfts"}, "ratio": ratio,
           "band": P23_RATIO_BAND, "wall_s": wall}
    log(f"23b calibrated simulator [{card}]: ServiceModel from 22c autoscale (unloaded TTFT "
        f"{measured['ttft_unloaded_s']:.4f}s from {measured['ttft_unloaded_source']}, TPOT p50 "
        f"{measured['tpot_p50_s']:.5f}s, warmup {measured['warmup_s']:.2f}s, mean prompt "
        f"{mean_prompt:.1f}); simulated {res.completed}/{len(entries)} completed, {res.shed_total} "
        f"shed, {res.scale_ups} scale-up(s) in {wall:.2f}s; TTFT p50 / p95 simulated "
        f"{p50:.4f} / {p95:.4f}s, measured {measured['ttft_p50_s']:.4f} / "
        f"{measured['ttft_p95_s']:.4f}s over {len(measured['ttfts'])} completions; ratio "
        f"{ratio:.3f} (band {P23_RATIO_BAND[0]:.3f}-{P23_RATIO_BAND[1]:.3f})")
    require(res.completed == len(entries) == 64 and res.shed_total == 0,
            f"23b: simulated {res.completed} completed, {res.shed_total} shed")
    require(measured["shed"] == 0 and measured["completed"] >= 64,
            f"23b: the fleet completed {measured['completed']}, shed {measured['shed']}")
    require(res.scale_ups >= 1 and measured["scale_ups"] >= 1,
            f"23b: scale-ups simulated {res.scale_ups}, measured {measured['scale_ups']}")
    require(P23_RATIO_BAND[0] <= ratio <= P23_RATIO_BAND[1],
            f"23b: simulated/measured TTFT p50 {ratio:.3f} outside {P23_RATIO_BAND}")
    return out


def _pth_fixtures():
    """``tests/torch_pth_fixtures.py``: the seeded state dicts and the
    functional oracles (no JAX)."""
    import importlib.util

    path = os.path.join(ROOT, "tests", "torch_pth_fixtures.py")
    spec = importlib.util.spec_from_file_location("torch_pth_fixtures", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def import_phase(torch, card: str, device: str = "cuda") -> dict:
    """23d: seeded ``.pth`` files (torchvision ResNet-18 names with DDP's
    ``module.`` prefix, 10 classes; the reference UNet, ``out_classes`` 2
    and 1) converted by ``cli.import_torch --device cuda`` in process; the
    model restored (verified) from each checkpoint against the functional
    oracle over the raw state dict on one batch, float32, TF32 off, the
    card's eval logits within 1e-5 relative L2; then ``train_resnet
    --resume --torch_padding --eval_only`` and ``train_unet --resume
    --reference_topology --eval_only`` on the imported checkpoints."""
    import shutil
    import tempfile

    from deeplearning_mpi_tpu_torch.cli import import_torch, train_resnet, train_unet
    from deeplearning_mpi_tpu_torch.runtime import bootstrap
    from deeplearning_mpi_tpu_torch.train import create_train_state
    from deeplearning_mpi_tpu_torch.train.checkpoint import Checkpointer
    from deeplearning_mpi_tpu_torch.utils.torch_import import strip_ddp_prefix

    fx = _pth_fixtures()
    work = tempfile.mkdtemp(prefix="phase23d-", dir=os.path.join(ROOT, "build"))
    out: dict = {"card": card}
    try:
        cases = {
            "resnet18": ({f"module.{k}": v for k, v in fx.resnet18_sd(width=64).items()},
                         ["--arch", "resnet18"], 64),
            "unet_2": (fx.unet_sd(widths=(64, 128, 256, 512), out_classes=2),
                       ["--arch", "unet", "--out_classes", "2"], 64),
        }
        for name, (sd, flags, size) in cases.items():
            t0 = time.perf_counter()
            pth = os.path.join(work, f"{name}.pth")
            torch.save(sd, pth)
            model_dir = os.path.join(work, name)
            require(import_torch.main(["--input", pth, *flags, "--model_dir", model_dir,
                                       "--device", device]) == 0, f"23d: {name} import")
            model, tx, filename = import_torch.build_target(
                import_torch.build_parser().parse_args(["--input", pth, *flags]), device)
            state, epoch = Checkpointer(os.path.join(model_dir, filename)).restore_verified(
                create_train_state(model, tx))
            model = state.model.eval()
            x = torch.randn(4, size, size, 3, generator=torch.Generator().manual_seed(23))
            raw = strip_ddp_prefix(sd)
            with torch.no_grad():
                got = model(x.to(device)).float().cpu()
                oracle = (fx.oracle_resnet18 if name == "resnet18" else fx.oracle_unet)(
                    x.permute(0, 3, 1, 2), raw)
            if name != "resnet18":
                oracle = oracle.permute(0, 2, 3, 1)
            rel = float((got - oracle).norm() / oracle.norm())
            out[name] = {"epoch": epoch, "rel_l2": rel, "max_abs": float((got - oracle).abs().max()),
                         "seconds": time.perf_counter() - t0}
            log(f"23d {name} [{card}]: imported on the card, restored verified epoch {epoch}; "
                f"eval logits vs the functional oracle (f32, TF32 off): rel L2 {rel:.3e}, max "
                f"abs {out[name]['max_abs']:.3e} in {out[name]['seconds']:.1f}s")
            require(rel <= 1e-5, f"23d: {name} logits rel L2 {rel} > 1e-5")
            del model, state
        # --eval_only through the trainers (train_unet's head has 1 class).
        pth = os.path.join(work, "unet_1.pth")
        torch.save(fx.unet_sd(widths=(64, 128, 256, 512), out_classes=1), pth)
        require(import_torch.main(["--input", pth, "--arch", "unet", "--model_dir",
                                   os.path.join(work, "unet_1"), "--device", device]) == 0,
                "23d: unet_1 import")
        for name, cli, flags in (("resnet18", train_resnet, P23_EVAL_RESNET),
                                 ("unet_1", train_unet, P23_EVAL_UNET)):
            t0 = time.perf_counter()
            trainer = cli.train([*flags, "--device", device, "--resume", "--eval_only",
                                 "--model_dir", os.path.join(work, name), "--coordinator",
                                 f"file://{os.path.join(work, name + '-rdzv')}",
                                 "--num_processes", "1", "--process_id", "0"])
            ev = trainer.history[-1]
            bootstrap.shutdown()
            out[f"{name}_eval_only"] = {k: v for k, v in ev.items()
                                        if isinstance(v, (int, float))}
            log(f"23d {cli.__name__.split('.')[-1]} --resume --eval_only on the import "
                f"[{card}]: {out[f'{name}_eval_only']} in {time.perf_counter() - t0:.1f}s")
            require("loss" in ev and math.isfinite(ev["loss"]), f"23d: {name} eval {ev}")
    finally:
        bootstrap.shutdown()
        shutil.rmtree(work, ignore_errors=True)
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", default=None, help="also write the results here as JSON")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(ROOT, "deeplearning_mpi_tpu_torch", "csrc")):
        print(f"chip_smoke: the port is not beside this script in {ROOT}", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from deeplearning_mpi_tpu_torch.ops.kernels import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = gpu_name_and_power()
    log(f"phase 1 card: {card} | torch {torch.__version__} cuda {torch.version.cuda}")

    # All builds start together; the phases that need no K4 (3, 7, 8, 9,
    # 12, 16) run while flash_decode.cu (~110 s, 128 kernels) still builds.
    t_build = time.perf_counter()
    decode_build: dict = {}

    def build_decode():
        try:
            decode_build["logs"] = _build.build_all(["flash_decode"], force=True)
        except Exception as err:  # raised again after the join
            decode_build["error"] = err

    decode_thread = threading.Thread(target=build_decode)
    decode_thread.start()
    logs = _build.build_all(["flash_attention_fwd", "flash_attention_bwd"], force=True)
    for name, out in logs.items():
        for line in out.splitlines():
            if line.strip():
                log(f"nvcc {name}: {line.strip()}")
    log(f"phase 2 build: {sorted(logs)} in {time.perf_counter() - t_build:.1f}s "
        "(flash_decode still building)")

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    t0 = time.perf_counter()
    check_k1(torch, gen)
    check_k1(torch, gen, K1_PP_CASES)
    log(f"phase 3 K1 vs plain OK in {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    check_k2k3(torch, gen)
    check_k2k3(torch, gen, K2K3_PP_CASES)
    log(f"phase 7 K2/K3 vs plain OK in {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    train = train_110m(torch, args.seed)
    log(f"phase 8 train OK in {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    train_cli()
    log(f"phase 9 train_lm CLI OK in {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    workloads = original_workloads(torch, card)
    log(f"phase 12 hello_world, ResNet-18 and UNet training over NCCL, checkpoint OK in "
        f"{time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    pp = pp_phase(torch, card, torch.Generator(device="cuda").manual_seed(args.seed + 16),
                  args.seed)
    log(f"phase 16 pipeline parallelism (the 110M model over pp 4 x 4 microbatches in bf16, "
        f"card vs CPU, the ViT trained through train_resnet, the --pp refusal) OK in "
        f"{time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    imports = import_phase(torch, card)
    log(f"phase 23 (23d) .pth import on the card (ResNet-18 and the reference UNet through "
        f"cli.import_torch against the functional oracle, --resume --eval_only) OK in "
        f"{time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    decode_thread.join()
    if "error" in decode_build:
        raise decode_build["error"]
    for line in decode_build["logs"]["flash_decode"].splitlines():
        if line.strip():
            log(f"nvcc flash_decode: {line.strip()}")
    log(f"phase 2 build: ['flash_decode'] done, waited {time.perf_counter() - t0:.1f}s for it "
        f"after phases 3, 7-9, 12, 16 and 23d, all builds in "
        f"{time.perf_counter() - t_build:.1f}s")
    t0 = time.perf_counter()
    check_k4(torch, gen)
    log(f"phase 4 K4 vs plain OK in {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    launches, k1_shape, fills, k4_len, profile = serve(torch, args.seed)
    log(f"phase 5 serve OK in {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    kernels = time_kernels(torch, gen, launches, k1_shape, fills, k4_len)
    log(f"phase 6 timing in {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    checkpoint = checkpoint_phase(torch, card, then=lambda model_dir: int8_serve(torch, model_dir))
    log(f"phase 10 checkpoint, resume, generate and serve, and 11c int8 KV serving OK in "
        f"{time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    features = engine_features(torch, args.seed, card)
    kernels.append(time_k4_int8(torch, gen, checkpoint["then"]["launches"]["K4_int8"], fills,
                                k4_len))
    log(f"phase 11 prefix cache, speculative decoding, int8 KV and warmup OK in "
        f"{time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    moe = moe_phase(torch, card, args.seed)
    log(f"phase 13 MoE LM (train, card vs CPU, CLIs, --ep over NCCL) OK in "
        f"{time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    seq = seq_phase(torch, card, gen, args.seed)
    kernels.extend(seq["kernels"])
    log(f"phase 14 sequence parallelism (ring and Ulysses at S8192, the 110M model over a ring "
        f"of 4, the --sp CLIs) OK in {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    tp = tp_phase(torch, card, gen, args.seed)
    kernels.extend(tp["kernels"])
    log(f"phase 15 tensor parallelism (the 110M model over tp 4 in bf16, card vs CPU, greedy "
        f"generation at tp 4, --zero_overlap over NCCL) OK in {time.perf_counter() - t0:.1f}s")
    kernels.extend(pp["kernels"])
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    compose = compose_phase(torch, card, torch.Generator(device="cuda").manual_seed(args.seed + 17))
    kernels.extend(compose["kernels"])
    log(f"phase 17 the parallel axes composed (pp 2 x tp 2, tp 2 x sp 2 ring and Ulysses, MoE "
        f"routing over 2 sequence shards, MoE experts over tp 2; the 110M widths in bf16) OK in "
        f"{time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    completed = completed_phase(torch, card, torch.Generator(device="cuda").manual_seed(
        args.seed + 18), args.seed)
    kernels.extend(completed["kernels"])
    log(f"phase 18 the parallel axes completed (--pp x --sp refused as the reference raises, "
        f"the MoE LM through 2 stages in bf16, adafactor over tp 2 and pp 2 card vs CPU) OK in "
        f"{time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    telemetry = telemetry_phase(torch, card, args.seed)
    log(f"phase 19 telemetry (train_lm with --metrics_dir --profile_dir --log_dir, the registry's "
        f"syncs a step off and on, traced phases, the engine's instruments and spans) OK in "
        f"{time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    compiler = compiler_phase(torch, card, args.seed)
    log(f"phase 20 the compiler layer (the 110M train step captured as one CUDA graph against "
        f"eager, the kernel cache in a fresh process, the tuning DB through cli.autotune, "
        f"train_lm --tuned_step --aot_warmup and serve_lm --tuning_db) OK in "
        f"{time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    resilience = resilience_phase(torch, card, args.seed)
    log(f"phase 21 the resilience layer (the 110M captured drill bitwise the unfaulted run, the "
        f"NaN step and the guardrail rollback, train_lm --chaos --max_restarts --aot_warmup) OK "
        f"in {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    serving = serving_resilience_phase(torch, card, gen, args.seed)
    kernels.extend(serving["kernels"])
    log(f"phase 22 the serving half of the resilience layer (serve_crash recovered eager and "
        f"warmed, the disaggregated pair with its roles in their lanes and a handoff stall, the "
        f"fleet's failover, hot swap, hedging and autoscaling through serve_lm, the control "
        f"plane re-adopting its replicas) OK in {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    last = phase_23(torch, card, serving)
    last["imports"] = imports
    log(f"phase 23 the last modules (the sanitizer over 21a's saves and 22a's engines and its "
        f"injections on a fresh warmed engine, the simulator calibrated from 22c's fleet, "
        f"12b on the native loader, the .pth imports) OK in {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    kernels[1:1] = time_training(torch, gen, train["launches"])
    extra = time_extra(torch, gen)
    log(f"phase 6 K1/K2/K3 training-shape, K4 long-cache and dense-vs-K4 timing in "
        f"{time.perf_counter() - t0:.1f}s")

    log(f"phase seconds: {PHASE_SECONDS} of {time.perf_counter() - t_start:.1f}s")
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card, "kernels": kernels, "extra": extra, "profile": profile,
                       "train": train, "checkpoint": checkpoint, "features": features,
                       "workloads": workloads, "moe": moe, "seq": seq, "tp": tp, "pp": pp,
                       "compose": compose, "completed": completed, "telemetry": telemetry,
                       "compiler": compiler, "resilience": resilience,
                       "serving_resilience": serving, "last_modules": last,
                       "phase_seconds": PHASE_SECONDS,
                       "seconds": time.perf_counter() - t_start}, f, indent=1)
    table = [{k: r[k] for k in (
        "name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
        "plain_ms", "bound_ms", "bound_by", "library_ms")} for r in kernels]
    log(json.dumps({"kernels": table}))
    log(gpu_name_and_power())
    log(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
