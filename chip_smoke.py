"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises (non-zero exit):

1. device  — the card, and nvidia-smi's name/power-limit line.
2. build   — nvcc builds every CUDA source of maggy_tpu_torch/ops/csrc, and
             g++ the native control-plane codec (maggy_tpu_torch/native/
             framing.cpp, host code) into build/native/: is_native() must
             hold, its HMAC equal hashlib's, its crc32c the Python table's,
             and its TFRecord scan the Python reader's records on
             titanic_loco's TFRecord (make_titanic_like written anew). Then
             python -m maggy_tpu_torch.analysis --json on the port's tree (a
             process of its own): its locks, order edges, unsuppressed
             findings (none, or the phase fails) and suppressions with their
             reasons, and its seconds.
3. kernels — each flash-attention kernel against its plain PyTorch version
             (bf16, bf16 with fp32 gradients, and fp32; every head dim the
             kernels take, D = 64, 72, ..., 256, at 2 x 256 keys, 4:2
             heads, causal and key-padded with a fully masked row, Sq =
             128 for a quarter of the dims; the BERT-base
             training shape with a padding mask that fully masks some rows,
             and bert_glue_hpo's (64 x 128 with a mask that keeps every
             key),
             a causal GQA shape, causal padded shapes at S=256 with fully
             padded rows, and the Llama-3-8B training shape: causal, GQA
             32:8, D=128, S=2048; the ring's block at a rank's shard of
             sequence parallelism, 1x4096, GQA 32:8, D=128, causal and
             not causal), dQ also in the mode that computes delta
             from the forward's output, each error beside its tolerance;
             each kernel's registers, local memory, shared memory and
             resident blocks per SM at every head dim (failing if a D=64
             tensor-core kernel spills; bf16 D=128 and D=80 local memory
             printed); kernel, plain and
             scaled_dot_product_attention times at the main paths' shapes
             (H2O-Danube-1.8B's 2 x 2048, GQA 32:8, D=80, causal, and the
             LoRA lanes' folded 8 x 2048, 32:8, D=128, causal, among them;
             the folded shape is also held against the plain versions)
             (SDPA's forward, backward and both are yardsticks, never used
             by the port; SDPA's backward also stands as library_bwd_ms
             beside each backward kernel in the kernels line).
4. slice   — the BERT-base (12 x 768, vocab 30522) ASHA + median-stopping
             sweep through maggy_tpu_torch.experiment.lagom on two thread
             runners. Launch counters are zeroed just before and read just
             after: every attention call of every step must have gone
             through the kernels, each step but a trial's first replayed
             from the CUDA graph its Trainer captured (train/warm.py; the
             flash kernels' launches recorded at capture are counted per
             replay). Then the swept model's logits against the same
             weights on the CPU path, the per-step time alone, eager
             (warm_start=False) and replayed in turns, and a torch.profiler
             breakdown of five replayed steps (with each flash kernel's
             device time per launch). Each step's loss is also a
             TensorBoard scalar (maggy_tpu_torch.tensorboard), and the first
             trial traces its steps 1 and 2 with tensorboard.start_trace /
             stop_trace. After the sweep the script decodes every event file
             itself (the port's TFRecord scanner, crcs verified, and
             decode_event here: the card's machine has no tensorboard): each
             trial dir one session start with the trial's hparams, a loss
             scalar for each step its records count, one session end; the
             experiment's tensorboard dir the HParams config and the
             telemetry scalars; one trace, with kernel events, under its
             trial's tensorboard dir.
5. slice_bo — the BERT-base sweep of examples/bert_glue_hpo.py (lr,
             warmup_frac, batch 32 or 64; median stopping) through
             experiment.lagom on two thread runners, three times: TPE,
             GP + Hyperband (BOHB-shaped, 13 trials) with the driver's
             prefetching suggester, and the same GP sweep with prefetch off.
             Each sweep must finish its controller's trial count with a
             model-proposed trial, no suggest() on the RPC server's thread,
             and launch counters (zeroed before each sweep) at 12 x steps;
             the prefetched GP sweep must have prefetch hits. Prints suggest
             latencies by source, hand-off gaps by runner, invalidations,
             lock fallbacks, step times beside the ASHA sweep's, wall times
             and the best values.
6. slice_llama — the Llama-3-8B LoRA sweep (4096 wide, vocab 128256, cut
             to LLAMA_LAYERS = 4 of its 32 layers,
             32/8 heads, remat) through experiment.lagom: ASHA over
             (lora_rank, lora_alpha, lr) on two thread runners, each trial
             building its model, only the adapters trained, batches of
             2 x 2048 tokens, the vocab-chunked loss. Launch counters are
             zeroed just before and read just after: the forward kernel
             runs twice per layer and step (remat), the backward kernels
             once. Then a 1-layer full-width model on the card against the
             CPU path (hidden states, loss, layer-0 adapter gradients), the
             chunked loss's time, the step time alone, a torch.profiler
             breakdown of three steps, and the phase's peak memory.
6b. slice_danube — slice_llama's LoRA sweep (ASHA over lora_rank,
             lora_alpha, lr on two thread runners, 2 x 2048 tokens, remat,
             the chunked loss) at H2O-Danube-1.8B's widths (arXiv:2401.16818:
             vocab 32000, 2560 wide, FFN 6912, 24 layers, 32/8 heads,
             head_dim 80, rope theta 1e4) at 6 of its 24 layers (depth
             cut for the script's time): the flash kernels
             at D=80, a width no earlier path runs. Danube's sliding window
             of 4096 keys covers all 2048 tokens, so the repo's Llama
             computes its function. Launches exact (the forward twice per
             layer and step, the backward kernels once), the journal
             replayed, the warm reading; then a 1-layer full-width model on
             the card against the CPU path (hidden states, loss, layer-0
             adapter gradients).
6c. slice_lora_lanes — vectorized lanes of a LoRA family at Llama-3-8B's
             widths (train/vmap.py: only the adapters stacked, the frozen
             bf16 base held once; remat under torch.func, models/remat.py;
             the chunked loss's batching rule, ops/losses.py), two arms.
             (a) The sweep: OptimizationConfig(vmap_lanes=4, num_workers=1,
             es_policy="median") over lr (DOUBLE_LOG 1e-5 to 1e-3), 9
             trials (the runner's first dispatch is scalar, so 8 ride two
             4-lane blocks, the second on the first's retired unit),
             LLAMA_LAYERS layers, remat, the chunked loss through
             return_hidden, batches of 2 x 2048 seeded tokens, 6 steps a
             trial, through the phase's own lane train function. Launch
             counters zeroed just before and read just after must be 2 /
             1 / 1 (fwd / dK,dV / dQ) x layers x dispatch steps, whatever
             K: a block step launches each kernel once a layer for all
             lanes. Every trial finalized once, the journal replayed, every
             step after a unit's first replayed from its graph, each
             block's unit holding exactly one base's frozen bytes (no
             frozen parameter stacked, with a gradient buffer or optimizer
             state), and the lanes at the smallest and largest rate within
             AB_LOSS_TOL["bert_base"] of a scalar Trainer of
             only_lora(adamw(lr)) at the same seed, rate and batches.
             (b) The full depth: one VmapTrainer of 4 LoRA lanes of the
             whole 32-layer model, eager, 3 steps: each lane's first loss
             against the unit module's eager forward (lora_b starts at
             zero), launches 2 / 1 / 1 x 32 x 3, the unit's bytes. Prints
             the block step p50, the units' frozen and stacked bytes, and
             the peak memory of the sweep, of (b)'s build (the base drawn
             in fp32, ROADMAP F5) and of (b)'s steps, beside reckonings
             made before the first chip run.
6d. slice_examples — the port's examples (maggy_tpu_torch/examples) as a
             user runs them: python -m maggy_tpu_torch.examples.mnist_hpo
             --trials 2 --workers 2 as a process of its own with no device
             variable set (exit 0, its Best line, 2 finalized trials, its
             start-up seconds); then main(argv) in this process with the
             JAX CI's smoke arguments for resnet_cifar_asha (at --depth 50),
             vit_cifar_hpo, pbt_sweep, titanic_ablation and
             distributed_training (their trial counts finalized, each
             journal replayed); then bert_glue_hpo at BertConfig.base's
             widths on its own tokens at length 128 (--trials 2: 40 steps a
             trial at batch 32 or 64, no attention mask, so every key is
             kept) and llama_lora_sweep at Llama-3-8B's widths (4 of 32
             layers, 2 x 2048 tokens, slice_llama's vocab chunk; --trials 2
             --resource-max 1: 20 steps a trial), each by setting the
             example's module-level model config, data and loss chunk
             before main. Launch counters zeroed just before each of the two
             and read just after must equal the examples' own arithmetic:
             BERT 12 layers x (steps + one accuracy pass a trial) forward
             and 12 x steps backward launches; Llama 2 x 4 x steps (remat)
             and 4 x steps. Every run dir, registry and temporary file is
             under build/. Prints each example's wall, trials, best value,
             launches against the expected, its trials' seconds a step and
             peak memory.
7. slice_process — the slice sweep under pool="process": two spawned runner
             processes, each with its own interpreter and CUDA context. Each
             trial writes its steps and its process's kernel launches to a
             file of its own; the launches summed over all runner processes
             must be 12 x steps for each kernel, over all 13 trials. Prints
             the in-sweep step median beside slice's (thread runners) and
             each runner process's peak memory.
8. slice_mnist — bench.py's headline sweep at its own widths: MnistCNN(3,
             2, 16 features, 2 classes) on 2048 x 16 x 16 x 1 data from
             make_data (seed 0), ASHA(3, 1, 9) + median stopping, 3 runners,
             batch in {128, 256, 512}, 40 steps a budget unit, under
             pool="thread" and pool="process". First the card's logits for
             one batch against the CPU's. Prints each sweep's wall time,
             trial count and in-sweep step median.
9. slice_recovery — the process sweep of slice_mnist with a loss timeout of
             3 s, in which the first trial to reach step 20 kills its own
             runner process (os._exit) and the second freezes its own
             (SIGSTOP). The sweep must return with two lost runners, every
             trial finalized once, and both faulted trials re-run to the
             end in another process. Prints the time from each fault to its
             requeue.
10. slice_fork — the slice sweep with checkpoint forking (config.fork, on by
             default): its train function takes ctx, saves the model,
             optimizer, scheduler and steps done at the end of each trial
             and, given ctx.resume_step, restores them and continues under
             its own schedule. Every promoted trial whose parent saved must
             be journaled forked_from that parent at its step and start at
             the step after it; derive's fork block must count the forks and
             the steps saved; launches must be 12 x the steps run; ckpt_gc
             must retire the parents whose children finalized. (The slice
             sweep, whose train function has no ctx, must journal no fork.)
             Prints wall, steps, steps saved, goodput buckets, fork-load,
             save and restore times with their share spent waiting for the
             checkpoint lock, and the run directory's peak bytes on disk
             beside slice's, then removes the run directory.
10b. slice_objstore — the slice_fork sweep (with a loss scalar a step) with
             its whole experiment dir in an object store: GCSEnv over
             SmokeStore, an fsspec-shaped stand-in defined here (objects
             under the phase's dir, committed whole at close, no append, no
             rename, if_generation_match=0 exclusive, ops and bytes
             counted; the card has no fsspec, gcsfs or network), installed
             with EnvSing.set_instance. Checkpoints, fork copies with their
             .fork_complete.<step> markers, the journal (its append refused,
             so full rewrites), trial.json files, TensorBoard event files
             and the summary all go to the store. The run is read back from
             the store and held to slice_fork's gates, launches at 12 x the
             steps, no tmp object, no local gs: path, no FINAL reply carrying
             an assignment (the inline FINAL path is off for a store) while
             prefetched suggestions still serve hand-offs, and one event
             file a trial decoded with a loss scalar a step. Then JAX
             tests/test_gcs_env.py's object-store resume: three trials of
             train_mnist_ckpt, one finalized trial.json torn to 17 bytes,
             resume=True to six trials (two restored, the torn one re-run).
             Prints the store's op counts and bytes, the checkpoint save,
             restore and fork-load p50 and the sweep's wall and goodput
             beside slice_fork's, and the phase's seconds.
11. slice_pbt — examples/pbt_sweep.py on the card: PBT(6 members, 4
             generations) over lr and weight decay, MnistCNN(3, 2, 8
             features, 2 classes) on make_data(512), 15 steps a segment,
             three thread runners; each segment restores its parent's
             weights and saves its own (skipped, as in the JAX package, when
             a donor further along staged a later step into its dir; the
             count is printed). The first generation >= 1 segment
             to run 5 steps is preempted through the driver's
             preempt_partition: it must be requeued to resume at its fork
             step and finalize once, every later segment must fork from the
             parent PBT named at that parent's newest step, and all 24
             segments must finalize.
12. slice_resume — two sweeps, each killed with SIGKILL mid-flight and
             resumed (OptimizationConfig(resume=True), the same app id and
             experiment_dir) in a new process; each incarnation runs as
             ``chip_smoke.py --resume-child <sweep> <incarnation>``, and the
             parent only watches files, kills and checks while a child holds
             the card. bert_base_resume is the slice_fork sweep with an
             unseeded ASHA and a 3 s loss timeout, killed once 4 trials
             finalized and the journal on disk shows one running (at a
             moment with a fork running, if one comes before 7 finalized);
             mnist_hyperband_resume is MnistCNN(3, 2, 16, 2) on
             make_data(2048) under RandomSearch(seed 7) + Hyperband(1, 9, 9)
             over lr and batch, 10 steps a budget unit, two thread runners,
             each trial marking a file named after its params and budget.
             Both must show incarnation 1 killed by the signal and 2 exiting
             0, driver epochs [1, 2] in the markers and the journal, one
             resumed and one recovered event (in flight >= 1), no trial
             finalized before the kill running again, each trial in flight
             at the kill requeued once (blacklist or heartbeat_loss) and
             finalized after the resume (one whose trial.json landed before
             the kill, its journal edge not: closed at the resume, stamped
             at its finish, neither requeued nor re-run), early_stopped counting both
             incarnations, and a journal that passes the replay checks.
             bert_base_resume also: a whole ASHA ladder (every promotion's
             parent finalized a rung below and promoted once, the top rung
             reached, 9 rung-0 trials unless the top rung finished first:
             ASHA then draws no more, and the resumed forks, finishing
             early, can bring that about), incarnation 2's launches at
             12 x its steps, promotions of parents saved before the kill
             forked at the parent's last step and trained from the step
             after, a fork in flight at the kill resumed at its fork step
             (recovery's fork count). mnist_hyperband_resume also: the
             bracket file present at the kill, every slot of the 12 run,
             only trials in flight at the kill run twice (at most one a
             runner), result.json counting the slots plus them. Prints each
             incarnation's wall time, the resume's time to its first
             assignment, the counts restored, recovered, requeued (by
             reason) and adopted, the rework, the forks resumed across the
             crash, the goodput of both incarnations and the peak bytes on
             disk.
13. slice_warm — bench.py's warm_start A/B (run_compile_ab) on the card,
             arm by arm: the fixed-shape RandomSearch(seed 11) sweep of 6
             trials on one thread runner, es_policy none, warm_start on
             then off, each from an empty warm cache (clear_warm). mnist:
             MnistCNN(3, 2, 16, 2) on make_data(2048), batch 256, budget 0.5
             (20 steps), swept_transform(adam, learning_rate=lr), lr
             DOUBLE_LOG [1e-4, 3e-2]; bert_base: BertConfig.base(), batch 32
             x 128 with key padding, swept_transform(adamw,
             learning_rate=lr) at a constant lr in DOUBLE_LOG [1e-5, 1e-4],
             8 steps a trial. The warm arms must show 5 hits and 1 miss from
             the journal's compile block and run from graphs, the cold arms
             0 hits and no graph, bert_base's kernels 12 x steps, and each
             warm trial's final loss the cold trial's of the same lr within
             AB_LOSS_TOL. Prints each arm's wall, hits and misses, ttfm p50
             warm and cold with bench's gate ratio (not gated), in-sweep step
             p50 and goodput buckets.
14. slice_resnet — examples/resnet_cifar_asha.py at --depth 50 (BASELINE.json
             config 3): ResNet(50, 2 classes, width in {32, 64}; 64 is
             ResNet-50's published width), fp32 with TF32 off, CIFAR stem,
             swept_transform(adamw, lr, weight_decay), has_aux_collections
             and train=True (BatchNorm's running statistics updated inside
             the captured step), ASHA(3, 1, 9) + median stopping (es_min 3),
             9 rung-0 trials on 3 thread runners, the example's
             ShardedBatchIterator (batch 128, seed 1) over make_cifar_like's
             seeded 1024 x 32 x 32 x 3 set on the card, 2 steps a budget
             unit (cut from 4; the example trains 8), a heartbeat every 2.
             Every step after a unit's first at its shape must replay a
             graph. Then 3 steps replayed against the same 3 taken eagerly
             from the same start at lr 0: the running
             statistics must agree within RESNET_BN_RTOL (a replay that
             updated them twice or not at all misses by about 10%), and so
             must a warm hit's (a unit stepped and retired, re-initialized
             in place: fresh statistics, every step replayed); at lr 1e-3,
             with cuDNN's deterministic algorithms, the replayed run against
             the same warm trainer stepped eagerly (its capturable AdamW)
             within RESNET_BN_RTOL, with two witnesses printed: capturable
             against plain AdamW, and two plain eager runs under the sweep's
             cuDNN settings; that model's eval logits against the CPU's
             within RESNET_LOGIT_RTOL. Prints hits and misses
             (weight decay joins the family by value: a hit is a promotion),
             goodput, the step alone eager and replayed, its profile, peak
             memory and the TF32 settings.
15. slice_vit — examples/vit_cifar_hpo.py at ViT-B/16 (ViTConfig.base(2)):
             TPE, 4 trials of 6 steps (cut from the example's 8 of 12:
             slice_examples runs the example itself), 2 threads, a plain
             adamw(lr) (each
             trial its own slot, as the example intends), batch 64 of a
             seeded 512 x 224 x 224 x 3 set (the example steps its whole set
             at once). 197 tokens do not tile by 128: the flash launches
             must be 0. A two-layer model at full width against the CPU,
             then the readings of slice_resnet.
16. slice_moe — slice_llama's LoRA sweep with experts: Llama-3-8B widths,
             8 experts a layer (top-2, capacity factor 2), 4 layers (cut by
             memory: phase_slice_moe), batch 2 x 2048, remat, 4 trials.
             Launches exact (llama3_8b_moe in the kernels line), every step
             after its warm-up replayed, each step's objective less its task
             loss equal to its summed aux loss. Prints the aux loss per
             step, the share of routed tokens dropped at capacity, the step
             alone and peak memory.
17. slice_lanes — the vectorized lanes (train/vmap.py; config.vmap_lanes).
             (a) bench.py's --vmap A/B at its own values: MnistMLP(8, 2) on
             make_data's 16 x 16 x 1 set, full batch 256, RandomSearch(seed
             7) over lr DOUBLE_LOG [1e-3, 3e-2], 25 trials, one thread
             runner, hb 0.05 s, es_policy none, arms scalar (the default),
             lanes1 (vmap_lanes=1) and vmap (vmap_lanes=8); bench's 2500
             steps a trial cut so that an arm takes about LANES_ARM_BUDGET_S
             (a scalar trial is timed first). Every trial finalized once in
             each arm, lanes1's finalized schedule scalar's with no
             lane-tagged edge, the vmap arm's lane-tagged assignments at
             least trials - K, each goodput closed; prints the speedup
             (scalar wall over vmap wall) beside bench's 5x gate, each arm's
             wall, step p50, goodput shares (lane_idle included) and a
             profiled replayed step of each (device idle share). (b) bench's
             _vmap_lane_parity engine gates (4 rates, 25 steps, TF32 off):
             each lane against its scalar Trainer within LANES_TOL, lane 1
             masked at step 10 with the survivors bitwise the unmasked
             block's, a refilled lane against a scalar cold run, a block
             re-initialized in the retired K-lane unit against a fresh one
             (bitwise printed). (c) The flash kernels' batching rule at
             BERT-base width: vmap of flash_attention and of its grad over 4
             lanes against each lane alone, one launch each. (d) slice_warm's
             BERT-base sweep (seed 11, 6 trials, 8 steps) with vmap_lanes=4,
             its blocks VmapTrainer steps on the card: launches 12 x the
             steps of each dispatch (a block's step once), each lane's final
             loss slice_warm's warm trial's of its lr within
             AB_LOSS_TOL["bert_base"], every step but a unit's first
             replayed; prints the 4-lane step alone replayed beside the
             scalar one x 4, its profile, and the phase's peak memory.
             (e) resnet50_lanes: 4 lanes of ResNet-50 (width 64, batch 128,
             fp32, TF32 off) with has_aux_collections and train=True, the
             stacked running statistics updated inside the captured
             VmapTrainer step; each lane against its own scalar Trainer:
             losses within RESNET_LANES_LOSS_TOL, parameters and running
             statistics within RESNET_LANES_TOL_PER_LR x its lr; the unit
             module's own buffers untouched, every step after the first
             replayed. (f) moe_lanes: 2 lanes of the MoE Llama (Llama-3-8B
             widths, 8 experts, 1 layer, bf16 parameters, every parameter
             trained, no LoRA, eager, batch 1 x 2048): each lane's
             objective with its load-balancing losses against its own
             scalar Trainer within AB_LOSS_TOL["bert_base"], the flash
             launches exactly one a layer and block step
             (llama3_8b_moe_lanes in the kernels line, at the Llama's
             shape: 2 lanes of batch 1).
18. slice_chaos — the port's chaos soaks (maggy_tpu_torch.chaos.harness)
             with trials that train on the card: train_mnist (budget
             CHAOS_BUDGET), train_mnist_vmap, and train_mnist_ckpt (each step
             checkpointed through the TrialContext, resumed from
             ctx.resume_step), hb 0.1 s, the health engine on. Sub-soaks,
             each printing violations (must be none), injections by kind
             (each planned kind at least once), recoveries with fault to
             requeue and fault to the re-run's first metric, health flags,
             wall, warm counters, retired warm units and allocated bytes
             before and after (and after dropping the units and the cuBLAS
             workspaces), peak memory: kill_thread (default_plan: a kill, a
             false preemption, METRIC drops, severed FINAL replies; thread
             runners), kill_process (default_plan on two runner processes,
             the kill a SIGKILL), piggyback (a kill in the hand-off's window:
             one requeue), stall_obs (an 8 s stall under a 5 s hang bound,
             obs_port=0: the health engine's hang flag, exactly one auto torch.profiler capture with
             threads.txt and a trace holding CUDA kernel events, /healthz 503
             during the stall and 200 after it), preempt (resumed from its
             acked checkpoint step >= 1), fork (the killed fork resumed from
             its fork point; the failover half across lagom(...,
             resume=True)), lanes (vmap_lanes=4: a torn block, every live
             lane requeued once) and control (no fault: no rework, at most 5%
             unaccounted, no health flag). Every sub-soak runs under the
             port's lock-order witness (lock_witness=True): its line's
             "witness" holds the edges seen, the forbidden ones (none, or
             the phase fails), the acquisitions noted and the witness's own
             seconds. Then check_invariants over every
             earlier phase's journal (build/chip_smoke_experiments*): no lost,
             phantom or twice-finalized trial and an ended experiment on each;
             each journal's raised health flags are printed, those of
             fault-free phases apart.
19. slice_ablation — LOCO ablation studies through experiment.lagom with an
             AblationConfig on thread runners, each journal replayed, each
             step after a unit's warm-up replayed, the LOCO schedule's trial
             ids finalized. titanic_loco: examples/titanic_ablation.py's
             study: make_titanic_like(2048, seed 0) written as a TFRecord and
             registered as "titanic" in a DatasetRegistry under the phase's
             directory, AblationStudy("titanic", version, "survived") over
             the 5 features, layers hidden_1 and hidden_2 and the prefix
             group hidden (9 trials, 3 runners), each an AblatableSequential
             with a lazy input layer trained full batch (Adam 1e-2, 60
             steps); each trial's parameter count its kept layers', sex the
             worst ablation, the base trial's accuracy above 0.8.
             bert_base_loco: BERT-base's 12 encoder layers on slice's data,
             the 12 singly, [layer_10, layer_11] and the prefix group layer_1
             (15 trials, 2 runners, 12 steps each, a constant-rate swept
             AdamW). filter_layers matches by name or prefix, so the single
             layer_1 trial drops layer_10 and layer_11 too, as the prefix
             group does: each flash kernel launched (12 + 11 x 11 + 9 + 10 +
             9) x 24 = 3864 times, warm hits >= 9 (one miss at most a runner
             and program: the 11 other single ablations are one 11-layer
             program). Prints each study's wall, step p50, goodput, warm
             hits and misses and peak memory.
20. slice_fleet — after clear_warm(): (a) maggy_tpu_torch.fleet.soak.
             run_fleet_soak() at its defaults (bench.py --fleet's shape:
             closed-form trials, a low-priority bulk sweep preempted by a
             high-priority arrival), ok with a preemption; (b) one
             Fleet(runners=2) in this process hosting two tenants through
             experiment.lagom_submit: bulk (priority low, RandomSearch, 4
             trials of FLEET_BERT_STEPS BERT-base steps on slice's data,
             saving through ctx.save_checkpoint every FLEET_SAVE_EVERY steps
             and on a preempt ack, resuming from ctx.resume_step) and, once
             bulk holds both runners, urgent (priority high, one runner, 2
             trials of slice_mnist's MnistCNN). The gates of run_fleet_soak
             (both schedules complete, check_invariants on each journal, a
             preemption in fleet.jsonl that the bulk journal executed, every
             checkpointed preemption resumed, the starvation bound FLEET_
             STARVATION_S), a checkpointed bulk trial resumed at its acked
             step, and each flash kernel's launches at 12 x the BERT steps
             its trials' records count (a preempted attempt's and its
             resumption's both). Prints wall, queue waits, preemptions, share
             against expected share, resumed_from_steps, preempt-to-resume
             time, each tenant's goodput, warm hits and misses, health flags
             and peak memory; (c) python -m maggy_tpu_torch.monitor --fleet
             <home> --once and python -m maggy_tpu_torch.telemetry trace
             <home>, each exiting 0, the fleet trace valid.
21. slice_remote — the slice sweep (ASHA(3, 1, 9) + median, 13 trials)
             under pool="remote", num_workers=2: two agent processes run
             python -m maggy_tpu_torch.runner --ticket <exp>/runner_ticket.
             json --train chip_smoke:train_bert_remote, each with its own
             CUDA context. Each trial's record file holds its agent's
             launches; summed they must be 12 x steps. While the sweep runs,
             python -m maggy_tpu_torch.monitor --ticket <ticket> --once, and
             with --telem, --health and --goodput, each exit 0. Prints the
             in-sweep step p50 beside slice_process's, JOIN to first trial
             per agent (the server's JOIN against the journal's first
             running edge of its partition) and each agent's peak memory.
22. slice_agents — fleet agents and the journal sink. (a) On the host:
             run_agent_soak(agents=2, trials=4) (agent processes on --device
             cpu, one SIGKILLed mid-lease) and run_sink_soak(tenants=2,
             trials=4) (the sink killed mid-run and restarted), each without
             a violation, under the lock-order witness (edges seen, no
             forbidden one, its acquisitions and seconds). (b) One Fleet(runners=1, max_agents=2, sink=True)
             and two python -m maggy_tpu_torch.fleet agent --ticket <home>/
             agent_ticket.json processes, each with its own CUDA context: an
             MNIST tenant (slice_fleet's urgent one, a partial: no name on the
             wire, so the thread runner serves it) and a BERT-base tenant
             (slice_fleet's schedule of 4 trials x 16 steps, batch 32 x 128,
             named chip_smoke:train_bert_agents, at most two runners), both
             with config.sink. Trials must run on both agents; the flash
             launches summed over the trials' records 12 x the steps; this
             process's launches its own records'; every tenant's journal,
             merged from the sink's segment and any local fallback, exactly
             once (check_exactly_once up to the driver's last event id) and
             through check_invariants; each agent's shipped journal exactly
             once; python -m maggy_tpu_torch.telemetry trace --unified <home>
             exiting 0. (c) A third tenant (2 trials of 96 steps, a 3 s loss
             bound): the first agent-leased trial past step 9 (or 1 s after
             its assignment) has its agent
             SIGKILLed (a kill_agent chaos record in its journal); the trial
             is requeued once, the lease ends agent_lost, the tenant
             finishes, the other agent exits 0 on the plane's AGSTOP. (d) One
             slice_mnist trial with profile=True: a trace in its trial's
             tensorboard dir holding CUDA kernel events. Prints AJOIN to first lease per
             agent, the agents' peak memory, the sink's ingest lag, the
             in-sweep step p50 beside slice_fleet's, the kill and the clock
             offsets.
23. slice_dist — distributed training through experiment.lagom with a
             DistributedConfig(backend="process"), three runs.
             llama3_8b_sp: two rank processes sharing the card over gloo
             (mesh {"seq": 2}, strategy "sp"): each first holds one layer's
             ring_attention (impl "flash") at Llama-3-8B's attention (32
             heads, 8 KV heads, D=128) on its shard of 8192 seeded tokens
             against flash_attention on the whole sequence, forward and
             gradients, within the kernels phase's bf16 tolerance; then the
             LoRA Llama-3-8B at full width (DIST_LAYERS layers: depth cut,
             remat, attention_impl="ring") trains DIST_STEPS mesh-Trainer
             steps on batch 1 x DIST_S (labels shifted over the whole
             sequence). Both ranks must report the same finite loss each
             step, and the flash launches summed over their records must be
             the ring's schedule (ring_schedule_launches). ulysses: the same
             check for ulysses_attention (eight all-to-alls a rank).
             resnet_dp: examples/distributed_training.py's train function
             on the port (ResNet-18 width 16, SGD with momentum, batch 128,
             4 epochs of its seeded data) on a world of one over NCCL. Each
             run's journal replayed (every worker registered and finalized
             once, the experiment started and ended); prints wall,
             rendezvous_ms, step p50 a rank, bytes and ms a ring hop, a
             gradient all-reduce and a loss all-reduce with the transport
             that ran, each rank's peak
             memory, the launches, beside nvidia-smi's line. Two ranks on
             one card time-slice it: correctness, not scaling. The rank
             processes are killed in a finally.
24. slice_gang — gang-scheduled trials (maggy_tpu_torch/gang.py).
             bert_base_gang: a BERT-base (full width, no dropout, key
             padding with every 8th row fully padded) ASHA(2, 1, 2) sweep
             of GANG_TRIALS rung-0 trials on GANG_RUNNERS thread runners
             with chips_per_budget {1: GangSpec(1), 2: GangSpec(2, "dp")}:
             rung 0 on one chip (captured), each promotion a 2-chip gang
             whose leader runs one rank process a chip, the ranks sharing
             the card over gloo and training on the mesh Trainer, BERT_B
             rows a rank; each gang's losses within AB_LOSS_TOL of one rank
             at the global batch from the same weights, the flash launches
             summed over its ranks equal to 2 ranks x 12 layers x
             GANG_STEPS, and no rank process alive after. Prints
             replay_pack (chip-seconds utilization, assembly latency,
             stalls), gangs assembled and released, step p50 of the 1-chip
             trials and of the ranks, each rank's peak memory and the
             sweep's goodput. bert_base_remote_gang: the same trial as a
             2-chip gang over two agent processes on one fleet (equal
             finite losses on both, exact launches, rendezvous_ms, the
             world's backend). Gang chaos: run_gang_soak with its ranks on
             the card, one member killed: one revocation, one
             gang_member_lost requeue, invariant 8, no rank left. Elastic:
             an MNIST ASHA sweep on pool="elastic" with total_chips=2 and
             chips_per_budget {1: 1, 2: 2}: at least one respawn, every
             trial on the lease its budget maps to, never more than 2
             chips leased in the journal's lease events.
25. slice_parallel — sharded parameters, expert and pipeline parallelism
             (maggy_tpu_torch/parallel/sharded.py, pipeline.py) through
             experiment.lagom(train_fn, DistributedConfig(...)), ranks
             sharing the card over gloo. First the one-device runs, freed
             before any rank starts. One world of two rank processes
             (backend "process") runs, each on a mesh of its own over it:
             llama3_8b_tp (slice_dist's 4-layer LoRA Llama-3-8B, remat,
             "tp" on {"model": 2}: 16 query and 4 kv heads a rank, 1 x 2048,
             4 steps), bert_base_fsdp (BERT-base, "fsdp" on {"fsdp": 2}, 32
             x 128 a rank, 3 steps) and llama3_8b_moe_ep (slice_moe's MoE
             Llama, "ep" on {"expert": 2}: 4 of 8 experts a rank, 1 x 2048,
             3 steps). Then pipelined_lm: PipelinedLM at Llama-3-8B's widths
             (2 stages x 2 layers, bf16 compute, 4 microbatches of 1 x 2048)
             on {"pipe": 2} over two remote agents (backend "remote"):
             pipeline_1f1b_grads and one GPipe step. Checked: equal finite
             losses on every rank, within 1e-2 x |loss| + 1e-3 of one
             device at the global batch; every parameter's shape what the
             logical rules give; each rank's peak memory of the steps below
             the one-device run's; flash launches exact (0 for the
             pipeline); the pipeline's output against apply_sequential and
             1F1B's stage gradients against GPipe's within the kernels'
             bf16 tolerance; the journals; no rank alive after. Prints step
             p50 a rank, traffic() by kind with its transport,
             rendezvous_ms, peak memory a rank and shard shapes.

The CPU tests hold the new models' warm path (tests/test_torch_resnet.py,
tests/test_torch_moe.py): a ResNet warm hit re-initializes its buffers in
place, bitwise a cold build's; has_aux_collections and the MoE config join
the program key; the aux loss enters the eager step's objective. Nothing
is captured there. The card re-checks under capture what a capture can
break: the BatchNorm updates of the replayed steps (slice_resnet, against
eager steps), a warm hit replaying the retired unit's graph on buffers
re-initialized in place (slice_resnet), and the summed aux loss computed
inside the captured region (slice_moe).

Every Trainer takes the warm path (train/warm.py; the train functions
build their models on device="meta"): each sweep's line has a "warm" field
(warm hits and misses, graphs captured and replayed, eager warm-up steps,
failed captures and their errors) and "captured". slice, slice_process,
slice_bo, slice_mnist, slice_fork, slice_pbt and slice_warm's warm arms
fail unless their steps replayed graphs and no capture failed, as do
slice_resnet, slice_vit and slice_moe; slice_llama may step eagerly only
where a capture raised (its reason and peak memory printed). clear_warm()
runs after each phase.

After every sweep, its telemetry journal (<exp_dir>/telemetry.jsonl) is
replayed through maggy_tpu_torch.telemetry and the sweep's line gets a
"telemetry" field: event count, torn lines, hand-off p50/p95 per runner,
the early-stop reaction, and the goodput ledger's buckets in seconds and
shares. The phase fails on a missing or torn journal, a finalized-trial
count other than result.json's, a finalized trial without queued ->
assigned -> running -> finalized, goodput buckets that do not sum to a
runner's held time, or result.json pipeline counts other than the
journal's; slice_recovery also on other than 2 lost runners and 2 requeues
or no rework. slice and slice_recovery write and validate a Perfetto
trace. slice_process and the MNIST process sweep print each runner's
queue wait, init and first-step time from the ledger, and slice_mnist
reruns its thread sweep with telemetry off and on in turns
(telemetry's cost where the host sets the pace).

Then the {"kernels": [...]} summary line (one entry per kernel and main
path, each with that path's launches, whether its steps ran captured, and
times at its shape; bert_base_resume's launches are incarnation 2's,
bert_base_warm's slice_warm's BERT-base warm arm's, llama3_8b_moe's
slice_moe's at the Llama shape's times, bert_base_lanes's slice_lanes'
at the folded shape, 4 lanes x batch 32, llama3_8b_moe_lanes's its MoE
arm's at the Llama's shape (2 lanes x batch 1), bert_base_loco's
slice_ablation's, bert_base_fleet's slice_fleet's card soak's,
bert_base_remote's slice_remote's summed over its agents,
bert_base_agents's slice_agents' BERT tenant's summed over its trials,
dist's slice_dist's llama3_8b_sp ranks' summed, timed at the ring's
block: 1 x 4096, causal, fp32 gradients; bert_base_gang's slice_gang's
gang ranks' summed over the in-process and remote gangs, eager;
llama3_8b_lora_lanes's slice_lora_lanes' sweep, timed at the folded shape,
4 lanes x batch 2 x 2048),
the
nvidia-smi line, and the last
line {"ok": true, "device": {...}}. Every phase line also goes to
build/chip_smoke_phases.jsonl beside the script (PHASE_LOG), which keeps
every line when a long output is cut. Needs one CUDA card; imports nothing of
JAX or maggy_tpu. Runner processes are spawned and re-import this file as
``__mp_main__``: importing it does no CUDA work, and their train functions
are the module-level ``train_*`` below.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import dataclasses
import faulthandler
import functools
import gc
import glob
import io
import itertools
import json
import math
import os
import re
import shutil
import signal
import struct
import subprocess
import sys
import threading
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

# H100 SXM data-sheet peaks (dense): HBM bytes/s and bf16 / fp32 FLOP/s.
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
SOURCE = "maggy_tpu_torch/ops/csrc/flash_attn.cu"
REPLACES = {"flash_fwd": "maggy_tpu/ops/attention.py:226",
            "flash_bwd_dkdv": "maggy_tpu/ops/attention.py:443",
            "flash_bwd_dq": "maggy_tpu/ops/attention.py:482"}
# BERT-base fine-tune: batch 32 at the padded length 128 (BASELINE.md config 4).
BERT_B, BERT_S = 32, 128
STEPS_PER_BUDGET = 4
# The budgets of the BERT sweeps' ASHA(3, 1, 9) rungs.
RUNG_BUDGETS = (1, 3, 9)
REPORT_EVERY = 2
# Llama-3-8B LoRA fine-tune: batch 2 x 2048 tokens (BASELINE.md config 5),
# its sweep at full width cut to LLAMA_LAYERS of the 32 layers (the
# script's time; launches and checks count the layers run).
LLAMA_B, LLAMA_S, LLAMA_LAYERS = 2, 2048, 4
LLAMA_STEPS_PER_BUDGET = 2
# slice_danube: H2O-Danube-1.8B cut to DANUBE_LAYERS of its 24 layers (the
# script's time), the sweep's batches those of slice_llama (2 x 2048 tokens).
DANUBE_LAYERS = 6
# slice_lora_lanes: Llama-3-8B LoRA lanes (LLAMA_LAYERS deep in the sweep,
# 32 in the full-depth arm). The sweep's lanes a block, trials (each
# runner's first dispatch is scalar, so 9 trials make two blocks of 4, the
# second on the first's retired unit) and steps a trial; the full-depth
# arm's steps and rates; and the reckonings of peak memory (GB) made before
# the first chip run (PERF.md): the sweep, two 4-layer bases of
# 3.85 GB (the scalar trial's retired unit and the lanes'), a build's fp32
# materialization (7.7 GB) and a step's activations; the full depth, the
# build's fp32 draw of the whole model (32.1 GB, then cast to 16.06 GB of
# bf16 base) against the steps' 16.06 GB of base, 0.93 GB of adapters and
# their state, 4.3 GB of remat inputs and about 8 GB of one layer's
# recompute and the chunked loss.
LORA_LANES_K, LORA_LANES_TRIALS, LORA_LANES_STEPS = 4, 9, 6
LORA_LANES_FULL_STEPS, LORA_LANES_FULL_LRS = 3, [1e-5, 1e-4, 3e-4, 1e-3]
LORA_LANES_SWEEP_RECKONING_GB = [16.0, 26.0]
LORA_LANES_RECKONING_GB = {"init": [32.1, 36.0], "steps": [24.0, 32.0]}
#: The scalar 32-layer Llama-3-8B LoRA sweep's peak (GB; PERF.md section 5),
#: printed beside the full-depth arm's.
SCALAR_32_LAYER_PEAK_GB = 68.07
# slice_examples: the arguments main gets (the JAX CI's smoke arguments,
# tests/test_examples.py:41-51; resnet_cifar_asha also at --depth 50,
# BASELINE configs[2]) and the trials each run finalizes; bert_glue_hpo's
# and llama_lora_sweep's steps a trial (their train functions'), the Llama
# loss's vocab chunk at full width (slice_llama's: chunked_next_token_loss's
# default) and how long the python -m run may take.
EXAMPLE_ARGS = {
    "mnist_hpo": ["--trials", "2", "--workers", "2"],
    "resnet_cifar_asha": ["--trials", "2", "--resource-max", "1", "--workers", "2",
                          "--depth", "50"],
    "vit_cifar_hpo": ["--trials", "2"],
    "pbt_sweep": ["--population", "2", "--generations", "2", "--workers", "2"],
    "titanic_ablation": [],
    "distributed_training": [],
    "bert_glue_hpo": ["--trials", "2"],
    "llama_lora_sweep": ["--trials", "2", "--resource-max", "1"]}
EXAMPLE_TRIALS = {"mnist_hpo": 2, "resnet_cifar_asha": 2, "vit_cifar_hpo": 2, "pbt_sweep": 4,
                  "titanic_ablation": 9, "bert_glue_hpo": 2, "llama_lora_sweep": 2}
BERT_EXAMPLE_STEPS, LLAMA_EXAMPLE_STEPS, LLAMA_EXAMPLE_VOCAB_CHUNK = 40, 20, 16384
EXAMPLE_CLI_TIMEOUT_S = 300
# The kernels phase holds every head dim the CUDA kernels take (the JAX
# rule D >= 64, D % 8 == 0, up to 256) against the plain versions.
KERNEL_CHECK_DIMS = tuple(range(64, 257, 8))
# slice_dist: Llama-3-8B at full width on a "seq" ring of DIST_RANKS rank
# processes sharing the card over gloo, DIST_LAYERS layers (depth cut), batch
# 1 x DIST_S tokens (DIST_S / DIST_RANKS a rank), DIST_STEPS steps; the
# ranks' records (read from the environment); the worlds' collective
# timeout (the heartbeat-loss bound); the ring block's heads and head dim.
DIST_RANKS, DIST_LAYERS, DIST_S, DIST_STEPS = 2, 4, 8192, 2
DIST_RECORDS_ENV = "MAGGY_TPU_SMOKE_DIST_RECORDS"
DIST_TIMEOUT_S = 120.0
DIST_H, DIST_HKV, DIST_D = 32, 8, 128
# The Bayesian-optimization sweeps of examples/bert_glue_hpo.py. Cuts: TPE
# runs 14 trials of 16 steps (the example: 8 trials; TPE fits its KDEs only
# from 2(d+1) = 8 finalized trials, and a suggestion prefetched while two
# trials run sees about k - 3 of its k predecessors finalized, so only the
# 12th and later can be model proposals), of 8 steps (cut from 16); GP +
# Hyperband runs 2 steps per budget unit (cut from 4); a heartbeat every 4
# steps and at a trial's last.
BO_TPE_TRIALS, BO_TPE_STEPS, BO_STEPS_PER_BUDGET, BO_REPORT_EVERY = 14, 4, 2, 4
#: (batch, Sq, Sk, heads, kv heads, head dim) of each main path's attention;
#: the BO sweeps add batch 64 (their search space is batch in {32, 64}).
MAIN_SHAPES = {"bert_base": (BERT_B, BERT_S, BERT_S, 12, 12, 64),
               "bert_base_bo": (64, BERT_S, BERT_S, 12, 12, 64),
               "llama3_8b": (LLAMA_B, LLAMA_S, LLAMA_S, 32, 8, 128),
               "bert_base_lanes": (4 * BERT_B, BERT_S, BERT_S, 12, 12, 64),
               "dist": (1, DIST_S // DIST_RANKS, DIST_S // DIST_RANKS, DIST_H, DIST_HKV,
                        DIST_D),
               # slice_parallel: tp's rank (16 of 32 query heads, 4 of 8 kv
               # heads) and the MoE Llama's ep rank at batch 1.
               "llama3_8b_tp": (1, LLAMA_S, LLAMA_S, 16, 4, 128),
               "llama3_8b_b1": (1, LLAMA_S, LLAMA_S, 32, 8, 128),
               # slice_danube: H2O-Danube-1.8B, 32:8 heads of 80.
               "danube_1_8b": (LLAMA_B, LLAMA_S, LLAMA_S, 32, 8, 80),
               # slice_examples' bert_glue_hpo: no attention mask (every
               # key kept), batch 64 of its space.
               "bert_glue_hpo": (64, BERT_S, BERT_S, 12, 12, 64),
               # slice_lora_lanes: LORA_LANES_K lanes of the Llama's batch
               # fold into one batch.
               "llama3_8b_lora_lanes": (LORA_LANES_K * LLAMA_B, LLAMA_S, LLAMA_S, 32, 8, 128)}
#: Paths whose attention is causal and unpadded (the rest: key padding,
#: or a mask that keeps every key).
CAUSAL_PATHS = ("llama3_8b", "dist", "danube_1_8b")
KEEP_ALL_PATHS = ("bert_glue_hpo",)
#: Paths that run the kernels at another path's shape: the process-runner,
#: forking, resumed, warm A/B and LOCO sweeps are the slice sweep's, the MoE
#: Llama's attention is the Llama's, and so is its lanes' (2 lanes of batch
#: 1 fold into the Llama's batch 2).
SAME_SHAPE = {"bert_base_process": "bert_base", "bert_base_fork": "bert_base",
              "bert_base_objstore": "bert_base",
              "bert_base_resume": "bert_base", "bert_base_warm": "bert_base",
              "bert_base_loco": "bert_base", "bert_base_fleet": "bert_base",
              "bert_base_remote": "bert_base", "bert_base_agents": "bert_base",
              "bert_base_gang": "bert_base", "bert_base_fsdp": "bert_base",
              "llama3_8b_moe": "llama3_8b", "llama3_8b_moe_ep": "llama3_8b_b1",
              "llama3_8b_moe_lanes": "llama3_8b", "bert_base_examples": "bert_glue_hpo",
              "llama3_8b_examples": "llama3_8b"}
#: Where the runners' trials train (a CPU rehearsal of the sweep phases
#: sets "cpu"; the script itself only runs on the card).
DEVICE = "cuda"
# bench.py's headline: MNIST CNN trials, 40 steps a budget unit, a swept
# batch size, a heartbeat metric every 2 steps.
MNIST_STEPS_PER_BUDGET = 40
MNIST_BATCHES = [128, 256, 512]
# slice_recovery: the step at which the two faulting trials fault, after
# FAULT_WAIT_S of heartbeats, and the loss timeout that detects them.
FAULT_STEP, FAULT_WAIT_S, RECOVERY_LOSS_TIMEOUT_S = 20, 0.5, 3.0
# slice_pbt (examples/pbt_sweep.py): steps a segment, and the steps the
# preempted segment runs before its preemption.
PBT_STEPS, PBT_PREEMPT_AFTER = 15, 5
# slice_fork writes about 1.3 GB a BERT-base checkpoint (fp32 weights and
# AdamW's two moments); the unpromoted rung-0 ones live until the sweep ends.
FORK_MIN_FREE_BYTES = 20e9
# slice_resume: its sweeps' root, the script its children run (a CPU
# rehearsal points it at its own), the BERT sweep's loss timeout, the
# Hyperband sweep's bracket ladder (eta 9: 12 trials in two brackets; cut
# from eta 3's 22 trials in three) and steps a budget unit (bench.py trains
# 40; cut, since the sweep only shows the bracket state across a crash),
# how long incarnation 1 may take to reach its kill point and incarnation 2
# to finish.
RESUME_ROOT = os.path.join(ROOT, "build", "chip_smoke_experiments_resume")
CHILD_SCRIPT = os.path.abspath(__file__)
RESUME_LOSS_TIMEOUT_S = 3.0
RESUME_HYPERBAND = {"min_budget": 1, "max_budget": 9, "eta": 9}
MNIST_RESUME_STEPS_PER_BUDGET = 10
RESUME_KILL_DEADLINE_S, RESUME_CHILD_TIMEOUT_S = 300, 420
# slice_warm (bench.py's run_compile_ab): trials an arm, the MNIST arm's
# batch and budget (20 steps at bench's 40 a unit), the BERT-base arm's
# steps a trial, and the tolerance (relative, absolute) of each warm trial's
# final loss against the cold trial's of the same lr. MNIST is fp32: the
# captured step's capturable AdamW computes its bias corrections on the card
# in fp32 where the eager one uses Python floats, an ulp or so of each
# update. BERT-base computes in bf16, where such an ulp can flip the
# rounding of an activation: a few bf16 roundings (2^-8 each) of the loss.
AB_TRIALS, AB_MNIST_BATCH, AB_MNIST_BUDGET, AB_BERT_STEPS = 6, 256, 0.5, 8
AB_LOSS_TOL = {"mnist": (1e-4, 1e-5), "bert_base": (1e-2, 1e-3)}
# slice_resnet (examples/resnet_cifar_asha.py at --depth 50): the widths
# swept (64 is ResNet-50's published width), the batch and seeded set, 8
# steps a budget unit, a heartbeat every 2 steps, the steps of the
# replayed-against-eager BatchNorm checks and their tolerance on the
# running statistics (relative to 1 + the largest value: the same weights,
# batches and arithmetic, so only the order of sums may differ), and the
# eval-logits tolerance against the CPU (TF32 off in every comparison:
# fp32 sums in another order through 50 layers).
RESNET_DEPTH, RESNET_WIDTHS, RESNET_BATCH, RESNET_N = 50, [32, 64], 128, 1024
RESNET_STEPS_PER_BUDGET, RESNET_REPORT_EVERY = 2, 2
RESNET_BN_STEPS, RESNET_BN_RTOL, RESNET_LOGIT_RTOL = 3, 1e-5, 1e-3
# slice_vit (examples/vit_cifar_hpo.py with ViTConfig.base(num_classes=2)):
# batch 64 of a seeded 512-image set (the example steps its whole set at
# once), 6 steps a trial, 4 TPE trials on two runners (cut from the
# example's 12 and 8: slice_examples runs the example itself), a heartbeat
# every 4.
VIT_N, VIT_BATCH, VIT_STEPS, VIT_TRIALS, VIT_REPORT_EVERY = 512, 64, 6, 4, 4
# slice_moe: the slice_llama LoRA sweep with 8 experts (top-2, capacity
# factor 2) at Llama-3-8B's widths, cut to MOE_LAYERS layers to fit one
# card (see phase_slice_moe).
MOE_LAYERS, MOE_EXPERTS, MOE_TOP_K, MOE_CAPACITY_FACTOR = 4, 8, 2, 2.0
# slice_lanes (bench.py --vmap, bench.py:107-164, 1264-1440): bench's lanes
# K, trials, seed, full batch, steps a trial and heartbeat cadence; the
# wall an arm may take (its steps are cut to fit: slice_lanes' "cut"); the
# engine gates' rates and steps; the tolerance (relative, absolute) of a lane
# against its scalar Trainer (fp32, TF32 off: a lane's products are one
# batched matmul, the scalar's a matmul, their sums in another order); and
# the BERT-base sweep's lanes, and the steps of its timed, profiled and
# eager-attributed runs alone (cut from 10, 5 and 3).
LANES_K, LANES_TRIALS, LANES_SEED, LANES_BATCH = 8, 25, 7, 256
LANES_BENCH_STEPS, LANES_REPORT_EVERY, LANES_ARM_BUDGET_S = 2500, 100, 1.0
LANES_PARITY_LRS, LANES_PARITY_STEPS, LANES_MASK_AT = [1e-3, 3e-3, 1e-2, 3e-2], 25, 10
LANES_TOL = (1e-4, 1e-5)
BERT_LANES = 4
BERT_LANES_ALONE_STEPS, BERT_LANES_PROFILE_STEPS, BERT_LANES_OP_STEPS = 5, 3, 1
#: The steps a trial of slice_lanes' MNIST arms trains (set by the phase).
LANES_STEPS = [LANES_BENCH_STEPS]
# slice_lanes' lanes of models with buffers or sowed losses. resnet50_lanes:
# slice_resnet's ResNet-50 at width 64 and batch 128, fp32 (TF32 off),
# has_aux_collections, captured; its lanes' rates, the weight decay baked
# into the family, the steps, and the tolerances of each lane against its
# own scalar Trainer: losses relative, and parameters and running
# statistics relative to 1 + the largest value, per unit of the lane's
# learning rate. vmap's batched convolutions take other cuDNN algorithms
# than the scalar ones, whose sums run in another order, and AdamW moves
# each weight by about lr a step whatever its gradient's size, so a
# near-zero gradient whose last bits differ can step the other way: up to
# 2 lr a step, 10 lr over the 5 steps, and BatchNorm's statistics of the
# deeper blocks carry such differences on. (A flat 1e-3 bound failed at lr
# 1e-3 on an H100: statistics 1.16e-2 off, parameters 5.59e-3, growing
# linearly with lr from 7.2e-4 at 1e-4; PERF.md.) The arm prints a witness
# beside them: a second scalar run at the largest rate against the first,
# under the same cuDNN settings.
# moe_lanes: the MoE Llama at Llama-3-8B's widths with MOE_EXPERTS experts
# a layer (top-2, capacity factor 2), without LoRA (every parameter
# trained and stacked; slice_lora_lanes holds a LoRA family's frozen base
# once), parameters in bf16, no remat, eager, MOE_LANES_LAYERS layers at MOE_LANES_K lanes, batches of
# MOE_LANES_B x 2048 tokens (the memory reckoning: lanes_moe_arm), each
# lane's objective against its scalar Trainer within
# AB_LOSS_TOL["bert_base"] (bf16 arithmetic).
RESNET_LANES_LRS, RESNET_LANES_WD = [1e-4, 2e-4, 5e-4, 1e-3], 1e-4
RESNET_LANES_STEPS, RESNET_LANES_LOSS_TOL, RESNET_LANES_TOL_PER_LR = 3, 1e-3, 20.0
MOE_LANES_K, MOE_LANES_LAYERS, MOE_LANES_STEPS, MOE_LANES_B = 2, 1, 3, 1
MOE_LANES_LRS = [1e-5, 1e-4]
# slice_ablation: examples/titanic_ablation.py's study (make_titanic_like's
# rows, 5 features, full batch, Adam 1e-2, 60 steps, 3 runners) and a LOCO
# study over BERT-base's 12 encoder layers on slice's data (a constant-rate
# swept AdamW, 12 steps a trial, 2 runners).
TITANIC_FEATURES = ["pclass", "sex", "age", "fare", "embarked"]
TITANIC_N, TITANIC_STEPS, TITANIC_LR, TITANIC_RUNNERS = 2048, 60, 1e-2, 3
BERT_LOCO_NAMES = ["embed"] + ["layer_{}".format(i) for i in range(12)] + ["head"]
BERT_LOCO_STEPS, BERT_LOCO_LR, BERT_LOCO_RUNNERS = 12, 3e-5, 2
# slice_fleet's card soak: the bulk tenant's trials, steps a trial and
# checkpoint cadence, the urgent tenant's trials, the scheduler's grace
# (run_fleet_soak's), the heartbeat, and the starvation bound (a first
# Trainer.init on the card takes 8-10 s, ROADMAP F3, and a BERT-base save
# about 2.3 s, F4: an urgent tenant can wait for both before its runner
# frees).
FLEET_BULK_TRIALS, FLEET_BERT_STEPS, FLEET_SAVE_EVERY, FLEET_URGENT_TRIALS = 4, 16, 8, 2
FLEET_GRACE_S, FLEET_HB_S, FLEET_STARVATION_S = 0.25, 0.1, 60.0
# slice_remote: where the agents' trials write their records (the agents
# read it from the environment), and how long the phase may wait for them.
REMOTE_RECORDS_ENV = "MAGGY_TPU_SMOKE_RECORDS"
REMOTE_TRAIN = "chip_smoke:train_bert_remote"
REMOTE_AGENT_TIMEOUT_S = 400
# slice_agents: the agents' trial functions, named by module as an ABIND
# lease names them (a function of __main__ has no name on the wire), where
# their trials write records (read from the environment), the BERT tenant's
# trials (slice_fleet's schedule: FLEET_BULK_TRIALS of FLEET_BERT_STEPS), the
# killed tenant's trials and steps, the step its kill waits for, its
# heartbeat-loss bound, and how long the phase waits for its agents. The
# kill waits for the trial's step AGENTS_KILL_AT_STEP in the driver's store,
# or for AGENTS_KILL_AFTER_S of the trial's assignment, whichever first.
AGENTS_BERT_TRAIN = "chip_smoke:train_bert_agents"
AGENTS_KILL_TRAIN = "chip_smoke:train_bert_agents_kill"
AGENTS_RECORDS_ENV = "MAGGY_TPU_SMOKE_AGENT_RECORDS"
AGENTS_KILL_TRIALS, AGENTS_KILL_STEPS, AGENTS_KILL_AT_STEP, AGENTS_KILL_AFTER_S = 2, 96, 9, 1.0
AGENTS_HB_LOSS_S, AGENTS_JOIN_TIMEOUT_S = 3.0, 180.0
#: Readings one phase leaves for a later one's line.
READINGS = {}
#: Every phase line of a run, one JSON object a line (emptied by main).
PHASE_LOG = os.path.join(ROOT, "build", "chip_smoke_phases.jsonl")
#: One bytecode cache for the script and every process it starts (runners,
#: ranks, agents, resume children). Where the environment forbids writing
#: bytecode (PYTHONDONTWRITEBYTECODE), each of them otherwise compiles
#: torch's modules from source at its start (``python3 -m
#: maggy_tpu_torch.train.init_probe`` measures it).
PYCACHE = os.path.join(ROOT, "build", "pycache")
#: When the script started: every phase line carries its ``t_s`` from here,
#: so the gaps between lines give each phase's wall.
T_START = time.perf_counter()


def emit(phase, **fields):
    """Print a phase line, and append it to PHASE_LOG, which keeps every
    phase line where only the end of a run's output is kept."""
    line = json.dumps({"phase": phase, **fields,
                       "t_s": round(time.perf_counter() - T_START, 3)})
    print(line, flush=True)
    os.makedirs(os.path.dirname(PHASE_LOG), exist_ok=True)
    with open(PHASE_LOG, "a") as f:
        f.write(line + "\n")


def share_bytecode():
    """Read and write bytecode under PYCACHE, here and in every process
    started from here (they inherit the environment)."""
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    os.environ["PYTHONPYCACHEPREFIX"] = PYCACHE
    sys.dont_write_bytecode = False
    sys.pycache_prefix = PYCACHE


def tolerance(dtype, ref):
    """bf16: 1e-2 of the largest plain value plus 1e-2 (outputs are rounded
    to bf16, 2^-8 relative, and fp32 sums run in another order); fp32:
    1e-4 relative plus 1e-5."""
    scale = float(ref.float().abs().max())
    return 1e-2 * scale + 1e-2 if dtype == torch.bfloat16 else 1e-4 * scale + 1e-5


def gpu_time_ms(fn, reps=20):
    """Mean device time of ``fn`` in ms, each call timed alone with CUDA
    events after evicting the 50 MB L2 (operands arrive cold, as they do
    from the surrounding training step)."""
    flush = torch.empty(256 * 1024 * 1024 // 4, dtype=torch.float32, device="cuda")
    fn()
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


# ------------------------------------------------------------------- phases


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], stdout=subprocess.PIPE,
                         text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    emit("device", kind=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
         nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)
    # float32 products in full precision on both sides of every comparison.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def phase_build():
    from maggy_tpu_torch.ops import build

    t0 = time.perf_counter()
    # The analyzer runs in a process of its own while nvcc builds.
    analysis = start_analysis()
    builds = build.compile_all()
    for name, variant in builds:
        build.library(name, variant)
    names = [build.build_name(*b) for b in builds]
    ptxas = [line.strip() for name in names
             for line in build.build_logs.get(name, "").splitlines() if "Used" in line]
    emit("build", sources=names, seconds=time.perf_counter() - t0,
         nvcc_s={name: build.build_seconds.get(name) for name in names},
         ptxas_register_lines=len(ptxas), ptxas_sample=ptxas[:3], native=native_check(),
         analysis=analysis_check(*analysis))


def start_analysis():
    """Start ``python -m maggy_tpu_torch.analysis --json`` on the port's
    tree in a process of its own, read by a thread that notes the seconds
    from its start to its exit: (process, thread, {"stdout", "stderr",
    "seconds"})."""
    out = {}
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", "maggy_tpu_torch.analysis", "--json"],
                            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def read():
        out["stdout"], out["stderr"] = proc.communicate()
        out["seconds"] = time.perf_counter() - t0

    thread = threading.Thread(target=read, daemon=True)
    thread.start()
    return proc, thread, out


def analysis_check(proc, thread, out):
    """The report of ``start_analysis``'s process: its locks, order edges,
    unsuppressed findings and suppressions (each with its reason), and its
    seconds from start to exit (beside nvcc, in the build phase). Any
    unsuppressed finding, or a non-zero exit, fails the phase."""
    thread.join(300)
    if thread.is_alive():
        proc.kill()
        thread.join()
        raise AssertionError("analysis ran past 300 s")
    try:
        report = json.loads(out["stdout"])
    except ValueError:
        raise AssertionError("analysis printed no report (rc {}):\n{}".format(
            proc.returncode, out["stderr"][-2000:]))
    out = {"rc": proc.returncode, "locks": report["num_locks"],
           "edges": len(report["lock_edges"]), "findings": report["findings"],
           "suppressed": len(report["suppressed"]),
           "suppressed_reasons": sorted({f["reason"] for f in report["suppressed"]}),
           "summary": report["summary"], "seconds": out["seconds"]}
    if proc.returncode != 0 or report["findings"] or \
            not all(f["reason"] for f in report["suppressed"]):
        raise AssertionError("maggy_tpu_torch.analysis: {}".format(out))
    return out


def py_tfrecord_records(path):
    """A TFRecord's payloads read in Python: each frame's length and payload
    crcs checked with the table crc32c."""
    from maggy_tpu_torch.train.tfrecord import py_crc32c

    def masked(data):
        crc = py_crc32c(data)
        return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF

    out, data, pos = [], open(path, "rb").read(), 0
    while pos < len(data):
        header = data[pos:pos + 8]
        (length,) = struct.unpack("<Q", header)
        (length_crc,) = struct.unpack("<I", data[pos + 8:pos + 12])
        payload = data[pos + 12:pos + 12 + length]
        (payload_crc,) = struct.unpack("<I", data[pos + 12 + length:pos + 16 + length])
        if length_crc != masked(header) or payload_crc != masked(payload):
            raise AssertionError("{}: a frame's crc is off at byte {}".format(path, pos))
        out.append(payload)
        pos += 16 + length
    return out


def pb_fields(buf):
    """(field number, value) of each field of one protobuf message: a
    varint as an int, fixed64 as a double, fixed32 as a float, a
    length-delimited field as its bytes."""
    from maggy_tpu_torch.train.tfrecord import _read_varint

    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            value, pos = _read_varint(buf, pos)
        elif wire == 1:
            (value,), pos = struct.unpack_from("<d", buf, pos), pos + 8
        elif wire == 5:
            (value,), pos = struct.unpack_from("<f", buf, pos), pos + 4
        elif wire == 2:
            n, pos = _read_varint(buf, pos)
            value, pos = bytes(buf[pos:pos + n]), pos + n
        else:
            raise ValueError("wire type {} of field {}".format(wire, field))
        yield field, value


def pb_value(buf):
    """A google.protobuf.Value: its number, string or bool."""
    for field, value in pb_fields(buf):
        if field == 2:
            return value
        if field == 3:
            return value.decode()
        if field == 4:
            return bool(value)
    return None


def decode_hparams(content):
    """An HParamsPluginData: ("session_start", {name: value}),
    ("session_end", status) or ("experiment", [hparam names])."""
    for field, value in pb_fields(content):
        if field == 3:
            hparams = {}
            for f, entry in pb_fields(value):
                if f == 1:
                    kv = dict(pb_fields(entry))
                    hparams[kv[1].decode()] = pb_value(kv.get(2, b""))
            return "session_start", hparams
        if field == 4:
            return "session_end", dict(pb_fields(value)).get(1)
        if field == 2:
            return "experiment", [dict(pb_fields(info))[1].decode()
                                  for f, info in pb_fields(value) if f == 4]
    return "unknown", None


def decode_event(raw):
    """One Event: its step, file_version and summary values, each (tag,
    simple_value or None, the HParams record or None)."""
    event = {"step": 0, "file_version": None, "values": []}
    for field, value in pb_fields(raw):
        if field == 2:
            event["step"] = value
        elif field == 3:
            event["file_version"] = value.decode()
        elif field == 5:
            for f, val in pb_fields(value):
                if f != 1:
                    continue
                v = dict(pb_fields(val))
                plugin = None
                if 9 in v:
                    pd = dict(pb_fields(dict(pb_fields(v[9]))[1]))
                    if pd.get(1) == b"hparams":
                        plugin = decode_hparams(pd.get(2, b""))
                event["values"].append((v[1].decode(), v.get(2), plugin))
    return event


def event_file_records(logdir):
    """Every event of the event files in ``logdir``, read through the
    port's TFRecord scanner with each frame's crcs verified: (files,
    events). Each file must open with the version record."""
    from maggy_tpu_torch import tensorboard
    from maggy_tpu_torch.train.tfrecord import iter_tfrecord

    files = sorted(glob.glob(os.path.join(logdir, tensorboard.EVENT_FILE_PREFIX + "*")))
    events = []
    for path in files:
        evs = [decode_event(raw) for raw in iter_tfrecord(path, verify=True)]
        if not evs or evs[0]["file_version"] != tensorboard.FILE_VERSION:
            raise AssertionError("{}: no version record first".format(path))
        events += evs[1:]
    return files, events


def tensorboard_check(name, exp_dir, records, searchspace, traced):
    """The TensorBoard files of a sweep under ``exp_dir``, decoded here
    (the card's machine has no tensorboard package): each trial dir holds
    one event file with one session start carrying the trial's hparams, a
    ``loss`` scalar for every step its records count, and one session end
    (STATUS_SUCCESS); the experiment's ``tensorboard`` dir holds the HParams
    config (the searchspace's names) and the telemetry scalars; with
    ``traced``, exactly one trial's trace lies in its ``tensorboard`` dir.
    Returns the reading; a mismatch raises."""
    from maggy_tpu_torch import tensorboard
    from maggy_tpu_torch.telemetry.profiling import TB_TRACE_SUFFIX

    t0 = time.perf_counter()
    problems, n_events, n_scalars, traces = [], 0, 0, []
    steps = collections.Counter()
    for r in records:
        steps[r["trial_id"]] += r["steps"]
    trial_files = sorted(glob.glob(os.path.join(exp_dir, "*", "*", "trial.json")))
    for path in trial_files:
        trial_dir = os.path.dirname(path)
        with open(path) as f:
            trial = json.load(f)
        logdir = os.path.join(trial_dir, "tensorboard")
        files, events = event_file_records(logdir)
        n_events += len(events)
        values = [v for e in events for v in e["values"]]
        starts = [p[1] for _, _, p in values if p and p[0] == "session_start"]
        ends = [p[1] for _, _, p in values if p and p[0] == "session_end"]
        losses = [e["step"] for e in events for tag, _, _ in e["values"] if tag == "loss"]
        n_scalars += len(losses)
        want = trial["params"]
        if len(files) != 1 or len(starts) != 1 or starts[0] != want or ends != [
                tensorboard.STATUS_SUCCESS] or len(losses) != steps[trial["id"]]:
            problems.append("{}: {} files, starts {} (want {}), ends {}, {} loss scalars for "
                            "{} steps".format(trial["id"], len(files), starts, want, ends,
                                              len(losses), steps[trial["id"]]))
        traces += glob.glob(os.path.join(logdir, "*" + TB_TRACE_SUFFIX))
    (run_dir,) = {os.path.dirname(os.path.dirname(p)) for p in trial_files}
    exp_files, exp_events = event_file_records(os.path.join(run_dir, "tensorboard"))
    exp_values = [v for e in exp_events for v in e["values"]]
    configs = [p[1] for _, _, p in exp_values if p and p[0] == "experiment"]
    telem = {tag: value for tag, value, p in exp_values if tag.startswith("telemetry/")}
    if configs != [list(searchspace.to_dict())]:
        problems.append("experiment config {} for {}".format(configs, list(searchspace.to_dict())))
    if telem.get("telemetry/trials_finalized") != len(trial_files):
        problems.append("telemetry scalars {}".format(telem))
    reading = {"trial_dirs": len(trial_files), "events": n_events, "loss_scalars": n_scalars,
               "experiment_files": len(exp_files), "telemetry_scalars": telem,
               "traces": [os.path.relpath(t, exp_dir) for t in traces],
               "decode_s": time.perf_counter() - t0}
    if traced:
        if len(traces) != 1:
            problems.append("{} traces, want one".format(len(traces)))
        else:
            cats = trace_categories(traces[0])
            reading.update(trace_kernel_events=cats.get("kernel", 0),
                           trace_bytes=os.path.getsize(traces[0]))
            if not cats.get("kernel"):
                problems.append("the trace holds no kernel event: {}".format(cats))
    if problems:
        raise AssertionError("{}: tensorboard: {}".format(name, "; ".join(problems)))
    return reading


def native_check():
    """The native codec (host code, framing.cpp) builds and loads, and
    agrees with hashlib and the Python routes."""
    import hashlib
    import hmac

    from maggy_tpu_torch import native
    from maggy_tpu_torch.train import tfrecord

    t0 = time.perf_counter()
    if not native.is_native():
        raise AssertionError("native codec did not load: {}".format(native.build_error))
    build_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    for n in (0, 1, 63, 64, 65, 4096, 1 << 20):
        key, msg = rng.bytes(int(rng.integers(1, 100))), rng.bytes(n)
        if native.hmac_sha256(key, msg) != hmac.new(key, msg, hashlib.sha256).digest():
            raise AssertionError("native HMAC off hashlib's at {} bytes".format(n))
        if native.crc32c(msg) != tfrecord.py_crc32c(msg):
            raise AssertionError("native crc32c off the table's at {} bytes".format(n))
    big = rng.bytes(1 << 24)
    t1 = time.perf_counter()
    native.crc32c(big)
    crc_s = time.perf_counter() - t1
    X, y = make_titanic_like()
    path = os.path.join(ROOT, "build", "native", "titanic.tfrecord")
    tfrecord.write_tfrecord(path, ({**{f: float(X[f][i]) for f in TITANIC_FEATURES},
                                    "survived": int(y[i])} for i in range(len(y))))
    data = open(path, "rb").read()
    scanned = [data[o:o + n] for o, n in native.tfrecord_scan(data)]
    if scanned != py_tfrecord_records(path) or len(scanned) != TITANIC_N:
        raise AssertionError("native TFRecord scan off the Python reader on {}".format(path))
    return {"native": True, "library": os.path.relpath(native.library_path(), ROOT),
            "load_s": build_s, "crc32c_16MiB_ms": crc_s * 1e3, "titanic_records": len(scanned)}


def make_inputs(B, Sq, Sk, H, Hkv, D, dtype, padded, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(B, Sq, H, D, device="cuda", generator=g).to(dtype)
    k = torch.randn(B, Sk, Hkv, D, device="cuda", generator=g).to(dtype)
    v = torch.randn(B, Sk, Hkv, D, device="cuda", generator=g).to(dtype)
    do = torch.randn(B, Sq, H, D, device="cuda", generator=g).to(dtype)
    mask = None
    if padded == "all":  # a keep-mask that keeps every key
        mask = torch.ones(B, Sk, dtype=torch.int32, device="cuda")
    elif padded:
        lens = torch.randint(16, Sk + 1, (B,), device="cuda", generator=g)
        lens[: max(1, B // 8)] = 0  # fully padded rows: output is the mean of V
        mask = (torch.arange(Sk, device="cuda")[None] < lens[:, None]).to(torch.int32)
    return q, k, v, do, mask


def live_entries(B, Sq, Sk, H, causal, mask):
    """Score entries the data needs: kept keys, causally visible."""
    keep = torch.ones(B, Sk, device="cuda") if mask is None else mask.float()
    vis = torch.ones(Sq, Sk, device="cuda")
    if causal:
        vis = vis.tril(Sk - Sq)
    return int((keep[:, None, :] * vis[None]).sum().item()) * H


def bound(nbytes, flops, dtype):
    t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_kernels(label, shape, causal, padded, results, main):
    """Every kernel and variant at ``shape`` against its plain version, in
    bf16 (with bf16 and fp32 gradients) and fp32; appends to ``results``,
    raises on a miss, and keeps each main path's bf16 error in ``main``."""
    from maggy_tpu_torch.ops import attention as A

    for dtype in (torch.bfloat16, torch.float32):
        q, k, v, do, mask = make_inputs(*shape, dtype, padded, seed=1)
        out, lse = A.flash_fwd(q, k, v, mask, causal)
        p_out, p_lse = A._plain_fwd(q, k, v, mask, causal)
        p_out = p_out.contiguous()
        delta = A._row_delta(do, p_out)
        dk, dv = A.flash_bwd_dkdv(q, k, v, do, p_lse, delta, mask, causal)
        p_dk, p_dv = A._plain_bwd_dkdv(q, k, v, do, p_lse, delta, mask, causal)
        dq = A.flash_bwd_dq(q, k, v, do, p_lse, delta, mask, causal)
        p_dq = A._plain_bwd_dq(q, k, v, do, p_lse, delta, mask, causal)
        # The mode the autograd backward runs: delta from the output.
        dq_f, delta_f = A.flash_bwd_dq(q, k, v, do, p_lse, None, mask, causal, out=p_out)
        live = p_lse > A.ALL_MASKED_LSE
        pairs = [("flash_fwd", "", [(out, p_out), (torch.where(live, lse, 0.0),
                                                   torch.where(live, p_lse, 0.0))]),
                 ("flash_bwd_dkdv", "", [(dk, p_dk), (dv, p_dv)]),
                 ("flash_bwd_dq", "", [(dq, p_dq)]),
                 ("flash_bwd_dq", "/fused_delta", [(dq_f, p_dq), (delta_f, delta)])]
        if dtype == torch.bfloat16:  # fp32 gradients (the ring building block)
            dk32, dv32 = A.flash_bwd_dkdv(q, k, v, do, p_lse, delta, mask, causal, True)
            dq32 = A.flash_bwd_dq(q, k, v, do, p_lse, delta, mask, causal, True)
            dq32_f, delta32_f = A.flash_bwd_dq(q, k, v, do, p_lse, None, mask, causal,
                                               True, out=p_out)
            pairs += [("flash_bwd_dkdv", "/grad_fp32", [(dk32, p_dk), (dv32, p_dv)]),
                      ("flash_bwd_dq", "/grad_fp32", [(dq32, p_dq)]),
                      ("flash_bwd_dq", "/fused_delta/grad_fp32",
                       [(dq32_f, p_dq), (delta32_f, delta)])]
        torch.cuda.synchronize()
        for name, variant, checks in pairs:
            err = max(float((a.float() - b.float()).abs().max()) for a, b in checks)
            tol = min(tolerance(dtype, b) for _, b in checks)
            ok = err <= tol and all(bool(torch.isfinite(a).all()) for a, _ in checks)
            results.append({"case": label + variant, "dtype": str(dtype),
                            "kernel": name, "max_abs_err": err, "tol": tol, "ok": ok})
            if not ok:
                emit("kernels", checks=results)
                raise AssertionError("{} disagrees with its plain version on {} {}: "
                                     "{} > {}".format(name, label + variant, dtype, err, tol))
            # Each path's error is that of the variant it runs: the
            # ring's blocks (causal and full) return fp32 gradients.
            path = "dist" if label == "dist_full" else label
            runs = "/grad_fp32" if path == "dist" and name != "flash_fwd" else ""
            if path in main and variant == runs and dtype == torch.bfloat16:
                prev = main[path].get(name, {}).get("max_abs_err", 0.0)
                main[path][name] = {"max_abs_err": max(prev, err)}


def phase_kernels():
    from maggy_tpu_torch.ops import attention as A

    # causal_pad_*: causal with padding and fully padded batch rows at
    # S=256, where the row's mean of V spans the unskipped 128-key tiles.
    cases = [("bert_base", MAIN_SHAPES["bert_base"], False, True),
             ("bert_base_bo", MAIN_SHAPES["bert_base_bo"], False, True),
             ("bert_base_lanes", MAIN_SHAPES["bert_base_lanes"], False, True),
             ("bert_glue_hpo", MAIN_SHAPES["bert_glue_hpo"], False, "all"),
             ("causal_gqa", (2, 128, 1024, 32, 8, 128), True, False),
             ("causal_pad_gqa", (8, 256, 256, 8, 2, 64), True, True),
             ("causal_pad_d96", (8, 256, 256, 4, 4, 96), True, True),
             ("llama3_8b", MAIN_SHAPES["llama3_8b"], True, False),
             ("llama3_8b_lora_lanes", MAIN_SHAPES["llama3_8b_lora_lanes"], True, False),
             ("danube_1_8b", MAIN_SHAPES["danube_1_8b"], True, False),
             ("dist", MAIN_SHAPES["dist"], True, False),
             ("llama3_8b_tp", MAIN_SHAPES["llama3_8b_tp"], True, False),
             ("llama3_8b_b1", MAIN_SHAPES["llama3_8b_b1"], True, False),
             # The ring's off-diagonal blocks: the rank's shard, not causal.
             ("dist_full", MAIN_SHAPES["dist"], False, False)]
    # Every head dim the kernels take: 2 x 256 keys, 4:2 heads, causal and
    # key-padded with the first batch row fully masked; Sq = 128 != Sk
    # where D % 32 == 8 (72, 104, ..., 232: dims with a half k16 step), so
    # the bottom-right causal offset meets the zero columns too.
    cases += [("d{}".format(D), (2, 128 if D % 32 == 8 else 256, 256, 4, 2, D), True, True)
              for D in KERNEL_CHECK_DIMS]
    results, main = [], {path: {} for path in MAIN_SHAPES}
    t_checks = time.perf_counter()
    for label, shape, causal, padded in cases:
        check_kernels(label, shape, causal, padded, results, main)
    checks_s = time.perf_counter() - t_checks
    A.reset_launch_counts()

    # What each kernel takes on the card, per head dim and type (and, for
    # the backward, per gradient type).
    variants = [(torch.bfloat16, False), (torch.bfloat16, True), (torch.float32, False)]
    resources = [{"kernel": name, "D": D, "width": A.kernel_width(D), "dtype": str(dtype),
                  "grad_fp32": g32, **A.kernel_resources(name, D, dtype, g32)}
                 for name in REPLACES for D in KERNEL_CHECK_DIMS
                 for dtype, g32 in variants if not (g32 and name == "flash_fwd")]
    spilling = [r for r in resources if r["D"] == 64 and r["dtype"] == str(torch.bfloat16)
                and r["local_bytes"]]
    if spilling:
        emit("kernels", checks=results, resources=resources)
        raise AssertionError("tensor-core kernels use local memory at D=64: {}".format(spilling))
    # The Llama and Danube paths' head dims: local memory is reported, not
    # gated.
    bf16_resources = {
        D: {"{}{}".format(r["kernel"], "/grad_fp32" if r["grad_fp32"] else ""):
            {key: r[key] for key in ("registers", "local_bytes", "blocks_per_sm")}
            for r in resources if r["D"] == D and r["dtype"] == str(torch.bfloat16)}
        for D in (128, 80)}

    # Times at each main path's shape and type (bf16): BERT-base padded,
    # Llama-3-8B and H2O-Danube-1.8B causal GQA.
    timed, yardsticks = {}, {}
    for path in MAIN_SHAPES:
        timed[path], yardsticks[path] = time_kernels(path, main[path])
    A.reset_launch_counts()
    llama = MAIN_SHAPES["llama3_8b"]
    emit("kernels", checks=results, checks_s=checks_s, head_dims=list(KERNEL_CHECK_DIMS),
         resources=resources, bf16_d128_resources=bf16_resources[128],
         bf16_d80_resources=bf16_resources[80],
         shape_main=[BERT_B, BERT_S, 12, 64], dtype=str(torch.bfloat16),
         timed=timed["bert_base"], **yardsticks["bert_base"],
         bert_base_bo={"shape": [64, BERT_S, 12, 64], "timed": timed["bert_base_bo"],
                       **yardsticks["bert_base_bo"]},
         bert_base_lanes={"shape": [4 * BERT_B, BERT_S, 12, 64],
                          "timed": timed["bert_base_lanes"], **yardsticks["bert_base_lanes"]},
         bert_glue_hpo={"shape": [64, BERT_S, 12, 64], "mask": "keeps every key",
                        "timed": timed["bert_glue_hpo"], **yardsticks["bert_glue_hpo"]},
         llama3_8b={"shape": [llama[0], llama[1], llama[3], llama[4], llama[5]],
                    "causal": True, "timed": timed["llama3_8b"], **yardsticks["llama3_8b"]},
         dist={"shape": [1, DIST_S // DIST_RANKS, DIST_H, DIST_HKV, DIST_D], "causal": True,
               "grad_fp32": True, "errors_over": ["dist", "dist_full"],
               "timed": timed["dist"], **yardsticks["dist"]},
         **{path: {"shape": [MAIN_SHAPES[path][i] for i in (0, 1, 3, 4, 5)], "causal": True,
                   "timed": timed[path], **yardsticks[path]}
            for path in ("llama3_8b_tp", "llama3_8b_b1", "danube_1_8b",
                         "llama3_8b_lora_lanes")})
    return main


def time_kernels(path, main):
    """Times of the three kernels at ``path``'s shape in bf16, written into
    ``main`` beside each one's bound, plain-version time and library time;
    returns (``main`` with the fused dQ's time, yardsticks). BERT-base is
    key-padded and not causal; Llama-3-8B causal, unpadded, GQA 32:8."""
    from maggy_tpu_torch.ops import attention as A

    B, S, _, H, Hkv, D = MAIN_SHAPES[path]
    causal = path.startswith(CAUSAL_PATHS)
    # The ring's backward blocks return fp32 gradients (flash_block_bwd).
    g32 = path == "dist"
    dtype = torch.bfloat16
    q, k, v, do, mask = make_inputs(B, S, S, H, Hkv, D, dtype,
                                    "all" if path in KEEP_ALL_PATHS else not causal, seed=2)
    out, lse = A.flash_fwd(q, k, v, mask, causal)
    delta = A._row_delta(do, out)
    n_live = live_entries(B, S, S, H, causal, mask)
    t_q = q.numel() * q.element_size()  # q, o, dO, dQ
    t_kv = k.numel() * k.element_size()  # k, v, dK, dV
    stat = B * H * S * 4
    mask_b = 0 if mask is None else mask.numel() * 4
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    if causal:
        sdpa_kw = dict(is_causal=True, enable_gqa=True)
    else:
        sdpa_kw = dict(attn_mask=mask.bool()[:, None, None, :])
    timing = {
        "flash_fwd": dict(
            ms=lambda: A.flash_fwd(q, k, v, mask, causal),
            plain=lambda: A._plain_fwd(q, k, v, mask, causal),
            library=lambda: sdpa(qt, kt, vt, **sdpa_kw),
            nbytes=2 * t_q + 2 * t_kv + stat + mask_b, flops=4 * D * n_live),
        "flash_bwd_dkdv": dict(
            ms=lambda: A.flash_bwd_dkdv(q, k, v, do, lse, delta, mask, causal, g32),
            plain=lambda: A._plain_bwd_dkdv(q, k, v, do, lse, delta, mask, causal),
            library=None, nbytes=2 * t_q + (4 + 2 * g32) * t_kv + 2 * stat + mask_b,
            flops=8 * D * n_live),
        "flash_bwd_dq": dict(
            ms=lambda: A.flash_bwd_dq(q, k, v, do, lse, delta, mask, causal, g32),
            plain=lambda: A._plain_bwd_dq(q, k, v, do, lse, delta, mask, causal),
            library=None, nbytes=(3 + g32) * t_q + 2 * t_kv + 2 * stat + mask_b,
            flops=6 * D * n_live),
    }
    for name, t in timing.items():
        b_ms, b_by = bound(t["nbytes"], t["flops"], dtype)
        main[name].update(ms=gpu_time_ms(t["ms"]), plain_ms=gpu_time_ms(t["plain"]),
                          bound_ms=b_ms, bound_by=b_by,
                          library_ms=gpu_time_ms(t["library"]) if t["library"] else None)
    # dQ computing delta as well: O read and delta written on top.
    f_ms, f_by = bound(4 * t_q + 2 * t_kv + 2 * stat + mask_b,
                       6 * D * n_live + 2 * D * B * S * H, dtype)
    timed = {n: dict(m) for n, m in main.items()}
    timed["flash_bwd_dq"].update(
        fused_ms=gpu_time_ms(lambda: A.flash_bwd_dq(q, k, v, do, lse, None, mask, causal,
                                                    out=out)),
        fused_bound_ms=f_ms, fused_bound_by=f_by)

    # Yardsticks: the three kernels vs SDPA's forward and backward, and the
    # backward pair (dQ computing delta, then dK/dV) vs SDPA's backward
    # alone on a kept graph.
    qg, kg, vg = (x.detach().clone().requires_grad_() for x in (qt, kt, vt))
    dot_ = do.transpose(1, 2)

    def sdpa_fwd_bwd():
        o = sdpa(qg, kg, vg, **sdpa_kw)
        torch.autograd.grad(o, (qg, kg, vg), dot_)

    def kernels_fwd_bwd():
        o, l_ = A.flash_fwd(q, k, v, mask, causal)
        kernels_bwd(o, l_)

    def kernels_bwd(o=out, l_=lse):  # what the autograd backward runs
        _, dl = A.flash_bwd_dq(q, k, v, do, l_, None, mask, causal, out=o)
        A.flash_bwd_dkdv(q, k, v, do, l_, dl, mask, causal)

    o_kept = sdpa(qg, kg, vg, **sdpa_kw)
    sdpa_bwd_ms = gpu_time_ms(
        lambda: torch.autograd.grad(o_kept, (qg, kg, vg), dot_, retain_graph=True))
    # SDPA's backward computes dQ, dK and dV in one call: a yardstick for
    # the two backward kernels together, not the function of either.
    for name in ("flash_bwd_dkdv", "flash_bwd_dq"):
        timed[name]["library_bwd_ms"] = main[name]["library_bwd_ms"] = sdpa_bwd_ms
    return timed, dict(fwd_bwd_ms=gpu_time_ms(kernels_fwd_bwd, reps=10),
                       sdpa_fwd_bwd_ms=gpu_time_ms(sdpa_fwd_bwd, reps=10),
                       bwd_pair_ms=gpu_time_ms(kernels_bwd), sdpa_bwd_ms=sdpa_bwd_ms)


LIFECYCLE = ("queued", "assigned", "running", "finalized")


def in_order(wanted, phases):
    """Whether ``wanted`` occurs in ``phases`` in that order."""
    it = iter(phases)
    return all(any(p == w for p in it) for w in wanted)


def journal_check(name, exp_dir, result, recovery=False, trace=False):
    """Replay the sweep's journal and hold it to result.json; returns the
    phase line's "telemetry" field (with the events, ledger and derive's
    fork block under "_events", "_goodput" and "_fork" for the caller)."""
    from maggy_tpu_torch.telemetry import derive, read_events
    from maggy_tpu_torch.telemetry.trace import validate_trace, write_trace

    paths = glob.glob(os.path.join(exp_dir, "*", "telemetry.jsonl"))
    if len(paths) != 1:
        raise AssertionError("{}: {} telemetry journals under {}".format(name, len(paths), exp_dir))
    events = read_events(paths[0])
    derived = derive(events)
    trial_events = [e for e in events if e["ev"] == "trial"]
    phases = {}
    for e in trial_events:
        phases.setdefault(e["trial"], []).append(e["phase"])
    finals = sum(p.count("finalized") for p in phases.values())
    gp = derived["goodput"]
    held = gp["held_chip_s"]
    problems = []
    if events.torn_lines:
        problems.append("{} torn lines".format(events.torn_lines))
    if not finals == sum("finalized" in p for p in phases.values()) == result["num_trials"]:
        problems.append("{} finalized events for {} trials in result.json".format(
            finals, result["num_trials"]))
    unordered = [t for t, p in phases.items() if "finalized" in p and not in_order(LIFECYCLE, p)]
    if unordered:
        problems.append("finalized without {}: {}".format(" -> ".join(LIFECYCLE), unordered))
    for pid, p in gp["per_partition"].items():
        if abs(sum(p["buckets"].values()) - p["held_s"]) > 1e-6 * p["held_s"]:
            problems.append("runner {}'s buckets sum to {} of {} s held".format(
                pid, sum(p["buckets"].values()), p["held_s"]))
    trial_phases = [e["phase"] for e in trial_events]
    counts = {"prefetch_hits": trial_phases.count("prefetch_hit"),
              "prefetch_misses": trial_phases.count("prefetch_miss"),
              "invalidated": sum(e["n"] for e in events if e["ev"] == "prefetch_invalidated"),
              "lock_fallbacks": sum(1 for e in trial_events
                                    if e["phase"] == "prefetch_miss" and e.get("lock_fallback"))}
    if counts != {k: result["pipeline"][k] for k in counts}:
        problems.append("pipeline {} against the journal's {}".format(
            {k: result["pipeline"][k] for k in counts}, counts))
    requeues = [e for e in trial_events if e["phase"] == "requeued"]
    if recovery and not (trial_phases.count("lost") == 2 and len(requeues) == 2
                         and all(e.get("reason") == "heartbeat_loss" for e in requeues)
                         and gp["buckets"]["rework"] > 0):
        problems.append("recovery: {} lost, requeues {}, rework {} s".format(
            trial_phases.count("lost"), [e.get("reason") for e in requeues],
            gp["buckets"]["rework"]))
    partitions = sorted({e["partition"] for e in trial_events if e.get("partition") is not None})
    out = {"events": len(events), "torn_lines": events.torn_lines,
           "handoff_ms": {str(p): derive([e for e in trial_events
                                          if e.get("partition") == p])["handoff"]
                          for p in partitions},
           "early_stop_reaction_ms": derived["early_stop_reaction"],
           "requeue_recovery_ms": derived["requeue_recovery"],
           "goodput": {"held_s": held,
                       "buckets_s": {b: v for b, v in gp["buckets"].items() if v},
                       "shares": {b: v / held for b, v in gp["buckets"].items() if v},
                       "goodput_fraction": gp["goodput_fraction"],
                       "unaccounted_fraction": gp["unaccounted_fraction"]}}
    if trace:
        path = os.path.join(os.path.dirname(paths[0]), "trace.json")
        n = write_trace(events, path)
        with open(path) as f:
            if validate_trace(json.load(f)) != n:
                problems.append("trace.json does not hold its {} events".format(n))
        out["trace_events"] = n
    if problems:
        emit(name, telemetry=out)
        raise AssertionError("{} telemetry: {}".format(name, "; ".join(problems)))
    out["_events"], out["_goodput"], out["_fork"] = events, gp, derived["fork"]
    out["_compile"] = derived["compile"]
    return out


#: Whether each main path's steps ran from CUDA graphs (the kernels line).
CAPTURED = {}


def journal_counters(events):
    """The warm path's counters summed over a journal's runners: each
    runner's last cumulative value in its runner_stats events, a value that
    goes back (a new runner on the partition, a resumed run) banking the one
    before, as derive's compile block does."""
    from maggy_tpu_torch.train.warm import COUNTER_KEYS

    cum, bank = {}, {}
    for e in events:
        if e["ev"] != "runner_stats":
            continue
        c, b = cum.setdefault(e["partition"], {}), bank.setdefault(e["partition"], {})
        for k in COUNTER_KEYS:
            if e.get(k) is not None:
                if int(e[k]) < c.get(k, 0):
                    b[k] = b.get(k, 0) + c[k]
                c[k] = int(e[k])
    return {k: sum(c.get(k, 0) for c in cum.values()) + sum(b.get(k, 0) for b in bank.values())
            for k in COUNTER_KEYS}


def warm_reading(name, telemetry=None, before=None, must_capture=True):
    """How a sweep's steps ran (train/warm.py): warm hits and misses,
    graphs captured and replayed, eager steps (one warm-up per unit and
    batch shape) and failed captures, from this process's counters since
    ``before`` (thread runners) or else from the journal's runner_stats
    (runner processes keep their own), with each failed capture's trial and
    error from the journal's compiled records. ``captured``: steps were
    replayed and no capture failed; with ``must_capture`` anything else
    fails the phase."""
    from maggy_tpu_torch.train import warm

    if before is not None:
        now = warm.counters()
        totals = {k: now[k] - before[k] for k in warm.COUNTER_KEYS}
    else:
        totals = journal_counters(telemetry["_events"])
    failed = [] if telemetry is None else [
        {"trial": e["trial"], "graph_error": e.get("graph_error")}
        for e in telemetry["_events"]
        if e["ev"] == "trial" and e["phase"] == "compiled" and e.get("graph_ok") is False]
    out = {"captured": totals["graph_replays"] > 0 and totals["graph_failures"] == 0
           and not failed, **totals, "graph_ok_false": failed}
    if must_capture and not out["captured"]:
        emit(name, warm=out)
        raise AssertionError("{}: steps did not run from CUDA graphs: {}".format(name, out))
    return out


def public(telemetry):
    return {k: v for k, v in telemetry.items() if not k.startswith("_")}


def runner_setup(telemetry):
    """Per runner (partition), from the goodput ledger: its queue wait
    (registered -> first trial running) and init (Trainer.init) in s, and
    each trial's first-step time (first broadcast less init) in ms."""
    first_step = {}
    for e in telemetry["_events"]:
        if e["ev"] == "trial" and e["phase"] == "compiled" and "first_step_ms" in e:
            first_step.setdefault(str(e["partition"]), []).append(e["first_step_ms"])
    return {str(pid): {"queue_wait_s": p["buckets"]["queue_wait"], "init_s": p["buckets"]["init"],
                       "first_step_ms": first_step.get(str(pid), [])}
            for pid, p in sorted(telemetry["_goodput"]["per_partition"].items())}


def make_dataset(vocab, n_batches, seed):
    """Token batches made from ``seed``: BERT-base's vocabulary, padded
    length 128, each row's true length drawn from [16, 128]; label =
    whether the upper half of the vocabulary dominates the real tokens."""
    rng = np.random.default_rng(seed)
    n = n_batches * BERT_B
    tokens = rng.integers(2, vocab, size=(n, BERT_S))
    lens = rng.integers(16, BERT_S + 1, size=n)
    mask = np.arange(BERT_S)[None, :] < lens[:, None]
    labels = ((tokens > vocab // 2) & mask).sum(1) * 2 > lens
    return (torch.as_tensor(tokens, device=DEVICE), torch.as_tensor(mask, device=DEVICE),
            torch.as_tensor(labels.astype(np.int64), device=DEVICE))


# ---------------------------------------------- trial functions of the runners
# Module-level, so a spawned runner process unpickles them by name (its
# import of this file as __mp_main__ runs only the definitions). Each
# process builds its data once, from the seed.

_DATA = {}
_DATA_LOCK = threading.Lock()


def cached(key, build):
    with _DATA_LOCK:
        if key not in _DATA:
            _DATA[key] = build()
        return _DATA[key]


def full_fp32():
    """float32 products in full precision (no TF32) in this process; a
    spawned runner starts from PyTorch's defaults, where cuDNN may run fp32
    convolutions in TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def bert_data():
    """(BERT-base config, batch(i)): the seeded token batches on the card."""
    from maggy_tpu_torch.models import BertConfig

    def build():
        cfg = BertConfig.base()
        tokens, mask, labels = make_dataset(cfg.vocab_size, 16, seed=0)
        n_batches = tokens.shape[0] // BERT_B

        def batch(i):
            lo = (i % n_batches) * BERT_B
            return {"inputs": (tokens[lo:lo + BERT_B], mask[lo:lo + BERT_B]),
                    "labels": labels[lo:lo + BERT_B]}

        return cfg, batch

    return cached("bert", build)


def labels_loss(logits, b):
    from maggy_tpu_torch.train import cross_entropy_loss

    return cross_entropy_loss(logits, b["labels"])


def process_age_s():
    """Seconds since this process started (Linux: /proc/self/stat's start
    time against the boot clock)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    return time.clock_gettime(time.CLOCK_BOOTTIME) - start_ticks / os.sysconf("SC_CLK_TCK")


class TrialRecord:
    """Made when a trial function is entered; when the trial ends (early
    stop and errors included), writes its steps, its step time, its set-up
    time (model, optimizer, data) and its process's age when it was entered,
    the kernel launches its process made meanwhile, the process's peak
    device memory and its pid to a file of its own, ``<out_dir>/<trial
    id>.<pid>.json``. A process runner runs one trial at a time, so there
    the launches are the trial's own; thread runners share the process's
    counters."""

    def __init__(self, out_dir, reporter):
        self.entered = time.perf_counter()
        self.process_age_s = process_age_s()
        self.trial_id = reporter.trial_id
        self.path = os.path.join(out_dir, "{}.{}.json".format(self.trial_id, os.getpid()))
        self.steps = 0
        # The first step index this run trains (a resumed fork's is past 0).
        self.first_step = 0

    def __enter__(self):
        from maggy_tpu_torch.ops import attention as A

        stream_sync()
        self.launches = A.launch_counts()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        from maggy_tpu_torch.ops import attention as A

        stream_sync()
        ms = (time.perf_counter() - self.t0) * 1e3
        record = {"trial_id": self.trial_id, "pid": os.getpid(), "steps": self.steps,
                  "first_step": self.first_step,
                  "step_ms": ms / max(self.steps, 1), "step_s": ms / 1e3,
                  "setup_s": self.t0 - self.entered, "process_age_s": self.process_age_s,
                  "launches": {k: n - self.launches[k] for k, n in A.launch_counts().items()},
                  "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
        with open(self.path + ".tmp", "w") as f:
            json.dump(record, f)
        os.replace(self.path + ".tmp", self.path)
        return False


def stream_sync():
    """Wait for this thread's stream. Runner threads never synchronize the
    whole device: a device-wide synchronize while another runner thread
    captures its step into a CUDA graph fails, and fails that capture."""
    torch.cuda.current_stream().synchronize()


def read_records(out_dir):
    records = []
    for name in sorted(os.listdir(out_dir)):
        if name.endswith(".json"):
            with open(os.path.join(out_dir, name)) as f:
                records.append(json.load(f))
    return records


def time_split(records):
    """Where a sweep's runner time went: each runner process's age when its
    first trial was entered (interpreter, imports, CUDA context, the
    driver's first assignment), and over all trials the set-up and the
    stepping seconds."""
    first = {}
    for r in records:
        first[r["pid"]] = min(first.get(r["pid"], r["process_age_s"]), r["process_age_s"])
    return {"first_trial_at_process_age_s": {str(p): a for p, a in sorted(first.items())},
            "setup_s": {"total": sum(r["setup_s"] for r in records),
                        "median": float(np.median([r["setup_s"] for r in records]))},
            "step_s_total": sum(r["step_s"] for r in records)}


def claim_once(flag):
    """True for the one caller (of any process) that creates ``flag``."""
    try:
        os.close(os.open(flag, os.O_CREAT | os.O_EXCL))
        return True
    except FileExistsError:
        return False


def train_bert_asha(lr, warmup_frac, budget, reporter, out_dir, trace_flag=None):
    """One trial of the BERT-base ASHA sweep (slice, slice_process): each
    step's loss also a TensorBoard scalar; with ``trace_flag``, the first
    trial to claim it traces its steps 1 and 2 with
    ``tensorboard.start_trace`` / ``stop_trace`` into its logdir."""
    from maggy_tpu_torch import tensorboard
    from maggy_tpu_torch.models import BertEncoder
    from maggy_tpu_torch.train import Trainer, adamw, warmup_cosine_decay_schedule

    record = TrialRecord(out_dir, reporter)
    full_fp32()
    cfg, batch = bert_data()
    total = int(budget) * STEPS_PER_BUDGET
    sched = warmup_cosine_decay_schedule(0.0, lr, int(total * warmup_frac), total)
    trainer = Trainer(BertEncoder(cfg, device="meta"), adamw(sched), labels_loss,
                      device=DEVICE).init(seed=0)
    traced = trace_flag is not None and claim_once(trace_flag)
    tracing = False
    with record:
        try:
            for i in range(total):
                if traced and i == 1:
                    tensorboard.start_trace()
                    tracing = True
                loss = trainer.step(batch(i))
                record.steps += 1
                tensorboard.add_scalar("loss", loss, step=i)
                if tracing and i == 2:
                    tracing = False
                    tensorboard.stop_trace()
                if i % REPORT_EVERY == REPORT_EVERY - 1 or i == total - 1:
                    reporter.broadcast(-loss, step=i)
        finally:
            if tracing:
                tensorboard.stop_trace()
    final = float(loss)
    if not math.isfinite(final):
        raise FloatingPointError("non-finite loss {}".format(final))
    return {"metric": -final}


def trainer_state(trainer):
    """What a BERT trial checkpoints: the model, AdamW's state and the
    learning-rate schedule's step."""
    return {"model": trainer.model.state_dict(), "optimizer": trainer.optimizer.state_dict(),
            "scheduler": trainer.scheduler.state_dict()}


def train_bert_fork(lr, warmup_frac, budget, reporter, ctx, out_dir, scalars=False):
    """One trial of the slice_fork, slice_objstore and slice_resume sweeps:
    train_bert_asha with a checkpoint of its state (and its last loss) at
    its end, and, for a fork, a resume from the staged parent checkpoint at
    the step after it under this trial's own schedule (its larger budget).
    A fork whose own final checkpoint is already in its dir (it trained to
    its end before an interruption, and only its FINAL was lost) restores
    that one and trains no step. With ``scalars`` each step's loss is also
    a TensorBoard scalar (slice_objstore), as in train_bert_asha."""
    from maggy_tpu_torch import tensorboard
    from maggy_tpu_torch.models import BertEncoder
    from maggy_tpu_torch.train import Trainer, adamw, warmup_cosine_decay_schedule

    record = TrialRecord(out_dir, reporter)
    full_fp32()
    cfg, batch = bert_data()
    total = int(budget) * STEPS_PER_BUDGET
    sched = warmup_cosine_decay_schedule(0.0, lr, int(total * warmup_frac), total)
    trainer = Trainer(BertEncoder(cfg, device="meta"), adamw(sched), labels_loss,
                      device=DEVICE).init(seed=0)
    if ctx.resume_step is not None:
        state = ctx.restore_checkpoint({**trainer_state(trainer), "steps_done": 0})
        if state is None or state["steps_done"] not in (ctx.resume_step + 1, total):
            raise RuntimeError("trial {} resumes at step {} but its checkpoint holds {}".format(
                reporter.trial_id, ctx.resume_step, state and state["steps_done"]))
        trainer.model.load_state_dict(state["model"])
        trainer.optimizer.load_state_dict(state["optimizer"])
        trainer.scheduler.load_state_dict(state["scheduler"])
        record.first_step = state["steps_done"]
        # The parent's last rate was its schedule's; step t of this trial
        # takes this trial's schedule(t), as its scheduler sets it after.
        for group in trainer.optimizer.param_groups:
            group["lr"] = sched(record.first_step)
    loss = state["loss"] if record.first_step == total else None
    with record:
        for i in range(record.first_step, total):
            loss = trainer.step(batch(i))
            record.steps += 1
            if scalars:
                tensorboard.add_scalar("loss", loss, step=i)
            if i % REPORT_EVERY == REPORT_EVERY - 1 or i == total - 1:
                reporter.broadcast(-loss, step=i)
    final = float(loss)
    if not math.isfinite(final):
        raise FloatingPointError("non-finite loss {}".format(final))
    # The step index of the last step trained: a fork resumes after it.
    ctx.save_checkpoint(total - 1, {**trainer_state(trainer), "steps_done": total,
                                    "loss": final})
    return {"metric": -final}


class PreemptOnce:
    """slice_pbt's preemption: the first generation >= 1 segment to have
    run PBT_PREEMPT_AFTER steps claims it, hands its partition to the
    script's timer thread, and waits until the driver has armed the
    preemption."""

    def __init__(self):
        self.claimed = threading.Event()
        self.armed = threading.Event()
        self.lock = threading.Lock()
        self.detail = {}

    def claim(self, trial_id, partition):
        with self.lock:
            if self.claimed.is_set():
                return False
            self.detail.update(trial_id=trial_id, partition=partition, at=time.time())
            self.claimed.set()
        if not self.armed.wait(60):
            raise RuntimeError("the preemption of trial {} was never armed".format(trial_id))
        return True


def train_pbt(lr, wd, generation, member, budget, ctx, reporter, preempt):
    """examples/pbt_sweep.py's train_fn on the card: MnistCNN(3, 2, 8, 2)
    under adamw(lr, wd) for PBT_STEPS steps a budget unit on make_data(512);
    a segment with a parent starts from its weights; each segment saves its
    weights as checkpoint ``generation``. The preempted segment reports
    every step after its claim (each report may raise its STOP)."""
    from maggy_tpu_torch.models import MnistCNN
    from maggy_tpu_torch.train import ShardedBatchIterator, Trainer, adamw

    full_fp32()
    X, Y = cached("pbt", lambda: make_data(n=512, key=0))
    model = MnistCNN(kernel_size=3, pool_size=2, features=8, num_classes=2, image_size=16,
                     device="meta")
    trainer = Trainer(model, adamw(lr, weight_decay=wd), labels_loss,
                      device=DEVICE).init(seed=member)
    if ctx.parent_trial_id is not None:
        restored = ctx.restore_parent({"model": trainer.model.state_dict()})
        if restored is not None:
            trainer.model.load_state_dict(restored["model"])
    it = iter(ShardedBatchIterator({"x": X, "y": Y}, batch_size=64, epochs=None, seed=member,
                                   device=DEVICE))
    every = 5
    for i in range(int(PBT_STEPS * budget)):
        b = next(it)
        loss = trainer.step({"inputs": (b["x"],), "labels": b["y"]})
        if i % every == 0:
            reporter.broadcast(-loss, step=i)
        if every == 1:
            time.sleep(0.05)  # heartbeats carry the STOP meanwhile
        elif i + 1 == PBT_PREEMPT_AFTER and generation >= 1 and \
                preempt.claim(reporter.trial_id, ctx.info["partition"]):
            every = 1
    ctx.save_checkpoint(generation, {"model": trainer.model.state_dict()})
    return {"metric": -float(loss)}


def make_data(n=2048, key=0):
    """bench.py's synthetic headline data: 16 x 16 x 1 images from a
    seeded normal, label = whether the image's mean is positive."""
    rng = np.random.default_rng(key)
    X = rng.normal(size=(n, 16, 16, 1)).astype(np.float32)
    y = (X.mean(axis=(1, 2, 3)) > 0).astype(np.int32)
    return X, y


def mnist_model(device):
    from maggy_tpu_torch.models import MnistCNN

    return MnistCNN(kernel_size=3, pool_size=2, features=16, num_classes=2, image_size=16,
                    device=device)


def fault(flag, reporter):
    """Claim ``flag`` (O_EXCL); the claiming trial lets a few heartbeats
    go out, then writes its trial id, pid and the time into the flag.
    True for the claimant."""
    try:
        fd = os.open(flag, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
    except FileExistsError:
        return False
    time.sleep(FAULT_WAIT_S)
    os.write(fd, json.dumps({"trial_id": reporter.trial_id, "pid": os.getpid(),
                             "at": time.time()}).encode())
    os.close(fd)
    return True


def train_mnist(lr, batch, budget, reporter, out_dir, kill_flag=None, wedge_flag=None,
                marker_dir=None, steps_per_budget=MNIST_STEPS_PER_BUDGET):
    """bench.py's train_mnist on the card: the budget-scaled MNIST CNN
    trial with ``swept_transform(adam, learning_rate=lr)`` (``bench.py:85``:
    every trial of a sweep shares one warm slot), a heartbeat every 2 steps. With the flags (slice_
    recovery), the first trial to reach FAULT_STEP kills its own process
    and the second freezes its own. With ``marker_dir`` (slice_resume), the
    trial first appends a byte to a file there named after its params and
    budget (``tests/test_resume.py:184-296``)."""
    from maggy_tpu_torch.train import ShardedBatchIterator, Trainer, adam, swept_transform

    if marker_dir is not None:
        with open(os.path.join(marker_dir, "{:.10f}_{}_{}".format(lr, batch, budget)), "a") as f:
            f.write("x")
    record = TrialRecord(out_dir, reporter)
    full_fp32()
    X, Y = cached("mnist", make_data)
    trainer = Trainer(mnist_model("meta"), swept_transform(adam, learning_rate=lr), labels_loss,
                      device=DEVICE).init(seed=0)
    steps = max(1, int(steps_per_budget * budget))
    it = iter(ShardedBatchIterator({"x": X, "y": Y}, batch_size=int(batch), epochs=None,
                                   seed=1, device=DEVICE))
    with record:
        for i in range(steps):
            b = next(it)
            loss = trainer.step({"inputs": (b["x"],), "labels": b["y"]})
            record.steps += 1
            if i % 2 == 0:
                reporter.broadcast(-loss, step=i)
            if i == FAULT_STEP and kill_flag is not None:
                if fault(kill_flag, reporter):
                    os._exit(42)
                if fault(wedge_flag, reporter):
                    os.kill(os.getpid(), signal.SIGSTOP)
    return {"metric": -float(loss)}


# ------------------------------------------------------------------- sweeps


def bert_asha_space():
    """The searchspace of the BERT-base ASHA sweeps (slice, slice_process)."""
    from maggy_tpu_torch import Searchspace

    return Searchspace(lr=("DOUBLE_LOG", [1e-5, 1e-3]), warmup_frac=("DOUBLE", [0.0, 0.3]))


def bert_asha_sweep(exp_dir, pool, train=train_bert_asha, experiment_dir=None, **train_kw):
    """The BERT-base ASHA(3, 1, 9) + median sweep on two runners of
    ``pool``: (result, wall s, records, the driver process's launches).
    Its experiment dir is ``experiment_dir`` (a store's ``gs://`` path in
    slice_objstore), else ``<exp_dir>/exp``; the records stay local.
    ``train_kw`` go to the train function."""
    from maggy_tpu_torch import OptimizationConfig, experiment
    from maggy_tpu_torch.ops import attention as A
    from maggy_tpu_torch.optimizers import Asha

    out_dir = fresh_dir(os.path.join(exp_dir, "records"))
    config = OptimizationConfig(
        name="bert_base_asha_smoke", num_trials=9,
        optimizer=Asha(reduction_factor=3, resource_min=1, resource_max=9, seed=0),
        searchspace=bert_asha_space(), direction="max", num_workers=2, es_policy="median",
        es_min=3, hb_interval=0.1, seed=0,
        experiment_dir=experiment_dir or fresh_dir(os.path.join(exp_dir, "exp")), pool=pool)
    A.reset_launch_counts()
    t0 = time.perf_counter()
    result = experiment.lagom(functools.partial(train, out_dir=out_dir, **train_kw), config)
    wall = time.perf_counter() - t0
    return result, wall, read_records(out_dir), A.launch_counts()


def check_bert_sweep(name, result, exp_dir, records, launches):
    """13 trials (promoted ones among them) each with its record, a finite
    best value, and launches at 12 x steps for each kernel."""
    cfg, _ = bert_data()
    trials = read_trials(os.path.join(exp_dir, "exp"))
    promoted = sum(1 for t in trials if t["info_dict"].get("sample_type") == "promoted")
    total_steps = sum(r["steps"] for r in records)
    expected = cfg.num_layers * total_steps
    if not (len(trials) == result["num_trials"] == len(records) == 13 and promoted > 0
            and all(t["status"] == "FINALIZED" for t in trials)
            and math.isfinite(result["best_val"])):
        raise AssertionError("{} sweep malformed: {} trials, {} records, {} promoted, "
                             "{}".format(name, len(trials), len(records), promoted, result))
    if any(n != expected for n in launches.values()) or expected == 0:
        raise AssertionError("{} launches {} != {} layers x {} steps".format(
            name, launches, cfg.num_layers, total_steps))
    return trials, promoted, total_steps, expected


def alone_step_ms(make_trainer, batch, warmup, n, pairs=2):
    """Per-step host-clock time of one trainer alone on the card, eager
    (warm_start=False) and replayed from its CUDA graph, in turns (eager,
    graph, ...): ({"eager": [ms, ...], "graph": [...]}, the last graph
    trainer)."""
    out, last = {"eager": [], "graph": []}, {}
    for warm_start in (False, True) * pairs:
        trainer = make_trainer(warm_start)
        for i in range(warmup):
            trainer.step(batch(i))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for i in range(n):
            trainer.step(batch(i))
        torch.cuda.synchronize()
        key = "graph" if warm_start else "eager"
        out[key].append((time.perf_counter() - t1) * 1e3 / n)
        last.pop(key, None)
        gc.collect()
        last[key] = trainer
    return out, last["graph"]


def phase_slice(exp_dir):
    from maggy_tpu_torch.models import BertEncoder
    from maggy_tpu_torch.train import Trainer, adamw, clear_warm, warm

    cfg, batch = bert_data()
    before = warm.counters()
    trace_flag = os.path.join(fresh_dir(os.path.join(exp_dir, "flags")), "trace")
    result, wall, records, launches = bert_asha_sweep(exp_dir, "thread", trace_flag=trace_flag)
    trials, promoted, total_steps, expected = check_bert_sweep(
        "slice", result, exp_dir, records, launches)
    tb_reading = tensorboard_check("slice", os.path.join(exp_dir, "exp"), records,
                                   bert_asha_space(), traced=True)
    telemetry = journal_check("slice", os.path.join(exp_dir, "exp"), result, trace=True)
    reading_warm = warm_reading("slice", telemetry, before)
    CAPTURED["bert_base"] = reading_warm["captured"]
    # The control of slice_fork: a train function without ctx saves nothing,
    # so no promotion forks.
    forks = sum(1 for e in telemetry["_events"]
                if e["ev"] == "trial" and e["phase"] == "forked_from")
    if forks:
        raise AssertionError("slice: {} forks from a train function without ctx".format(forks))
    step_ms = [r["step_ms"] for r in records]

    # The swept model against the same weights on the CPU (reference
    # attention, no kernel), on a small input.
    model = BertEncoder(cfg, device="cuda")
    model.init_weights(torch.Generator(device="cuda").manual_seed(3))
    small = batch(0)
    toks, msk = small["inputs"][0][:2], small["inputs"][1][:2]
    with torch.no_grad():
        gpu_logits = model(toks, msk)
        cpu_logits = copy.deepcopy(model).to("cpu")(toks.cpu(), msk.cpu())
    logit_err = float((gpu_logits.cpu() - cpu_logits).abs().max())
    logit_tol = 5e-2 * float(cpu_logits.abs().max()) + 5e-2
    if not (torch.isfinite(gpu_logits).all() and logit_err <= logit_tol
            and gpu_logits.shape == (2, cfg.num_classes)):
        raise AssertionError("BERT-base logits off the CPU path: {} > {}".format(
            logit_err, logit_tol))

    # Per-step time of one trainer alone on the card, eager and replayed
    # from its graph in turns, then a profile of five steps as the sweep
    # runs them (the profiler sees the kernels of a graph's replay).
    del model
    alone, graph_trainer = alone_step_ms(
        lambda ws: Trainer(BertEncoder(cfg, device="meta"), adamw(1e-4), labels_loss,
                           device="cuda", warm_start=ws).init(seed=0),
        batch, warmup=3, n=10)
    profile = step_device_profile(lambda i: graph_trainer.step(batch(i)))
    del graph_trainer
    clear_warm()

    emit("slice", trials_finished=len(trials), promoted=promoted,
         early_stopped=result["early_stopped"], best_hp=result["best_hp"],
         best_val=result["best_val"], steps=total_steps, forks=forks, launches=launches,
         expected_launches_each=expected, sweep_wall_s=wall,
         step_ms_in_sweep_median=float(np.median(step_ms)),
         step_ms_alone=float(np.median(alone["graph"])),
         step_ms_alone_eager=float(np.median(alone["eager"])), step_ms_alone_pairs=alone,
         step_profile=profile, warm=reading_warm, time_split=time_split(records),
         pipeline=pipeline_summary(result["pipeline"]), telemetry=public(telemetry),
         logits_max_abs_err=logit_err, logits_tol=logit_tol, tensorboard=tb_reading,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    reading = {"sweep_wall_s": wall, "steps": total_steps, "forks": forks,
               **fork_reading(telemetry)}
    return launches, float(np.median(step_ms)), reading


def fork_reading(telemetry):
    """A sweep's checkpoint-forking numbers from its journal: goodput
    buckets (s) and shares, derive's fork block, the p50 of the trials'
    fork-load, save and restore ms, and the part of the save and restore
    time spent waiting for the process's checkpoint lock (the other
    runner's save or restore)."""
    trial = [e for e in telemetry["_events"] if e["ev"] == "trial"]
    ckpt = [e for e in trial if e["phase"] == "ckpt_saved"]

    def p50(values):
        return float(np.median(values)) if values else None

    def lock_share(kind):
        total = sum(e.get(kind + "_ms", 0.0) for e in ckpt)
        return sum(e.get(kind + "_lock_ms", 0.0) for e in ckpt) / total if total else None

    return {"ckpt_lock_wait_share": {"save": lock_share("save"),
                                     "restore": lock_share("restore")},
            "save_lock_ms_p50": p50([e["save_lock_ms"] / e["saves"] for e in ckpt
                                     if e.get("saves") and "save_lock_ms" in e]),
            "goodput_s": telemetry["goodput"]["buckets_s"],
            "goodput_shares": telemetry["goodput"]["shares"],
            "fork": telemetry["_fork"],
            "fork_load_ms_p50": p50([e["fork_load_ms"] for e in trial
                                     if e["phase"] == "compiled" and "fork_load_ms" in e]),
            "save_ms_p50": p50([e["save_ms"] / e["saves"] for e in ckpt if e.get("saves")]),
            "restore_ms_p50": p50([e["restore_ms"] / e["restores"] for e in ckpt
                                   if e.get("restores")])}


class DiskPeak:
    """Samples the bytes under a directory every 0.25 s on a thread of its
    own; ``peak`` is the largest sum seen."""

    def __init__(self, path):
        self.path, self.peak = path, 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True, name="disk-peak")

    def _bytes(self):
        total = 0
        for root, _, names in os.walk(self.path):
            for name in names:
                try:
                    total += os.path.getsize(os.path.join(root, name))
                except OSError:  # removed meanwhile (a prune, a GC)
                    pass
        return total

    def _run(self):
        while not self._stop.wait(0.25):
            self.peak = max(self.peak, self._bytes())

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, self._bytes())
        return False


def fork_gates(trials, records, telemetry, reading, has_checkpoints):
    """slice_fork's gates on a forking sweep: every promoted trial whose
    parent saved is journaled forked_from that parent at its last step and
    trains from the step after it; derive's fork block counts the forks and
    the steps saved; every spent parent below the top rung is retired by
    ckpt_gc, and none still holds checkpoints (``has_checkpoints(trial id)``:
    on the local disk or in the store). Returns (forks by trial, the trials
    gc'd, problems)."""
    events = [e for e in telemetry["_events"] if e["ev"] == "trial"]
    forks = {e["trial"]: e for e in events if e["phase"] == "forked_from"}
    gced = {e["trial"] for e in telemetry["_events"] if e["ev"] == "ckpt_gc"}
    by_id = {t["id"]: t for t in trials}
    first_step = {r["trial_id"]: r["first_step"] for r in records}
    problems = []
    for t in trials:
        parent = t["info_dict"].get("parent")
        if parent is None:
            continue
        # A parent that was not early-stopped saved at its last step.
        if not by_id[parent]["early_stop"]:
            want = int(by_id[parent]["params"]["budget"]) * STEPS_PER_BUDGET - 1
            fork = forks.get(t["id"])
            if fork is None or fork.get("parent") != parent or fork.get("step") != want:
                problems.append("trial {} not forked from {} at step {}: {}".format(
                    t["id"], parent, want, fork))
    for tid, fork in forks.items():
        if first_step.get(tid) != fork["step"] + 1:
            problems.append("forked trial {} trained from step {}, not {}".format(
                tid, first_step.get(tid), fork["step"] + 1))
    if not (forks and reading["fork"].get("forked") == len(forks)
            and reading["fork"].get("steps_saved", 0) > 0):
        problems.append("derive's fork block {} for {} forks".format(reading["fork"], len(forks)))
    # ckpt_gc: every parent that saved and whose promoted child finalized is
    # retired. The journal holds each retirement but those of the top rung's
    # parents, which happen when the sweep is exhausted and may land after
    # the journal closed.
    spent = {t["info_dict"]["parent"] for t in trials if t["info_dict"].get("parent")
             and not by_id[t["info_dict"]["parent"]]["early_stop"]}
    top = {t["info_dict"].get("parent") for t in trials
           if t["params"]["budget"] == RUNG_BUDGETS[-1]}
    kept = {tid for tid in spent if has_checkpoints(tid)}
    if kept or not (spent - top) <= gced:
        problems.append("ckpt_gc: spent parents {}, still holding checkpoints {}, journaled "
                        "{}".format(sorted(spent), sorted(kept), sorted(gced)))
    return forks, gced, problems


def join_fork_gc():
    """Wait for the last FINAL's checkpoint GC, which may still be
    deleting."""
    for t in threading.enumerate():
        if t.name == "fork-gc":
            t.join(120)


def phase_slice_fork(exp_dir, slice_reading):
    """The slice sweep with checkpoint forking, beside slice's readings."""
    from maggy_tpu_torch.train import clear_warm, warm

    os.makedirs(exp_dir, exist_ok=True)
    free = shutil.disk_usage(exp_dir).free
    if free < FORK_MIN_FREE_BYTES:
        raise AssertionError("slice_fork needs {:.0f} GB free for its checkpoints; {} has "
                             "{:.1f} GB".format(FORK_MIN_FREE_BYTES / 1e9, exp_dir, free / 1e9))
    gc.collect()
    torch.cuda.empty_cache()
    fresh_dir(exp_dir)
    before = warm.counters()
    with DiskPeak(exp_dir) as disk:
        result, wall, records, launches = bert_asha_sweep(exp_dir, "thread", train=train_bert_fork)
        join_fork_gc()
    trials, promoted, total_steps, expected = check_bert_sweep(
        "slice_fork", result, exp_dir, records, launches)
    telemetry = journal_check("slice_fork", os.path.join(exp_dir, "exp"), result, trace=True)
    reading = fork_reading(telemetry)
    reading_warm = warm_reading("slice_fork", telemetry, before)
    CAPTURED["bert_base_fork"] = reading_warm["captured"]
    clear_warm()
    (run_dir,) = glob.glob(os.path.join(exp_dir, "exp", "*", ""))
    forks, gced, problems = fork_gates(
        trials, records, telemetry, reading,
        lambda tid: os.path.isdir(os.path.join(run_dir, tid, "checkpoints")))
    line = {"trials_finished": len(trials), "promoted": promoted, "forks": len(forks),
            "early_stopped": result["early_stopped"], "best_val": result["best_val"],
            "steps": total_steps, "launches": launches, "expected_launches_each": expected,
            "sweep_wall_s": wall, "disk_peak_bytes": disk.peak, "ckpt_gc": len(gced),
            "disk_free_before_bytes": free, **reading, "warm": reading_warm,
            "slice": slice_reading,
            "pipeline": pipeline_summary(result["pipeline"]), "telemetry": public(telemetry)}
    emit("slice_fork", **line)
    if problems:
        raise AssertionError("slice_fork: {}".format("; ".join(problems)))
    READINGS["slice_fork"] = {k: line[k] for k in (
        "sweep_wall_s", "save_ms_p50", "restore_ms_p50", "fork_load_ms_p50", "forks")}
    READINGS["slice_fork"]["goodput_fraction"] = telemetry["goodput"]["goodput_fraction"]
    shutil.rmtree(exp_dir)
    return launches


class SmokeStore:
    """A small fsspec-shaped object store for slice_objstore (test
    scaffolding, not a package feature: the card's machine has neither
    fsspec nor gcsfs, and no network). ``gs://<bucket>/<key>`` objects are
    files under ``<root>/objects/<bucket>/<key>``; a prefix is a directory.
    An object written is private until ``close`` and then commits whole (a
    write that raises commits nothing); ``if_generation_match=0`` commits
    only where no object exists; ``"a"`` raises, as GCS has no append; there
    is no rename or ``mv``. Counts puts, gets, lists, deletes and bytes, and
    logs every committed key in order."""

    def __init__(self, root):
        self.root = root
        self._lock = threading.Lock()
        self._uploads = itertools.count()
        self.ops = collections.Counter()
        self.puts = []  # committed keys, oldest first; guarded-by: _lock
        os.makedirs(os.path.join(root, "uploads"), exist_ok=True)

    def _count(self, op, n=1):
        with self._lock:
            self.ops[op] += n

    def _local(self, path):
        if not path.startswith("gs://"):
            raise ValueError("not an object path: {!r}".format(path))
        key = path[len("gs://"):].strip("/")
        if not key or ".." in key.split("/"):
            raise ValueError("bad object key: {!r}".format(path))
        return os.path.join(self.root, "objects", key)

    def exists(self, path, **kw):
        self._count("head")
        return os.path.exists(self._local(path))

    def isdir(self, path):
        self._count("head")
        return os.path.isdir(self._local(path))

    def makedirs(self, path, exist_ok=False):
        os.makedirs(self._local(path), exist_ok=exist_ok)

    def ls(self, path, detail=True, **kw):
        self._count("list")
        local = self._local(path)
        if not os.path.isdir(local):
            raise FileNotFoundError(path)
        out = []
        for name in sorted(os.listdir(local)):
            full = os.path.join(local, name)
            out.append({"name": path.rstrip("/") + "/" + name,
                        "type": "directory" if os.path.isdir(full) else "file",
                        "size": 0 if os.path.isdir(full) else os.path.getsize(full)})
        return out if detail else [e["name"] for e in out]

    def rm(self, path, recursive=False, **kw):
        self._count("delete")
        local = self._local(path)
        if os.path.isdir(local):
            if recursive:
                shutil.rmtree(local)
            else:
                os.rmdir(local)
        else:
            os.remove(local)

    def open(self, path, mode="rb", **kw):
        if "a" in mode or "+" in mode:
            self._count("append_refused")
            raise NotImplementedError("an object store has no append: {}".format(path))
        local = self._local(path)
        if "r" in mode:
            if kw:
                raise TypeError("unexpected arguments {}".format(sorted(kw)))
            self._count("get")
            return _StoreReader(self, open(local, mode))
        match = kw.pop("if_generation_match", None)
        if kw:
            raise TypeError("unexpected arguments {}".format(sorted(kw)))
        upload = os.path.join(self.root, "uploads", str(next(self._uploads)))
        return _StoreWriter(self, path, local, upload, open(upload, mode), match)

    def commit(self, path, local, upload, nbytes, match):
        with self._lock:
            if match == 0 and os.path.exists(local):
                os.remove(upload)
                raise FileExistsError("412 precondition failed (generation 0): " + path)
            os.makedirs(os.path.dirname(local), exist_ok=True)
            os.replace(upload, local)
            self.ops["put"] += 1
            self.ops["put_bytes"] += nbytes
            self.puts.append(path)

    def snapshot(self):
        with self._lock:
            return dict(self.ops), list(self.puts)

    def objects(self):
        """Every committed object's path."""
        base = os.path.join(self.root, "objects")
        return sorted("gs://" + os.path.relpath(os.path.join(d, n), base)
                      for d, _, names in os.walk(base) for n in names)


class _StoreReader:
    """A read handle that counts the bytes it reads."""

    def __init__(self, store, f):
        self._store, self._f = store, f

    def read(self, *args):
        data = self._f.read(*args)
        self._store._count("get_bytes", len(data))
        return data

    def readinto(self, buf):
        n = self._f.readinto(buf)
        self._store._count("get_bytes", n or 0)
        return n

    def __getattr__(self, name):
        return getattr(self._f, name)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._f.close()
        return False


class _StoreWriter:
    """A private upload that commits at ``close`` (discarded when the
    ``with`` block raises)."""

    def __init__(self, store, path, local, upload, f, match):
        self._store, self._path, self._local = store, path, local
        self._upload, self._f, self._match = upload, f, match
        self._n = 0
        self.closed = False

    def write(self, data):
        self._n += len(data)
        return self._f.write(data)

    def flush(self):
        self._f.flush()

    def tell(self):
        return self._f.tell()

    def writable(self):
        return True

    def close(self):
        if self.closed:
            return
        self.closed = True
        self._f.close()
        self._store.commit(self._path, self._local, self._upload, self._n, self._match)

    def discard(self):
        self.closed = True
        self._f.close()
        os.remove(self._upload)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *exc):
        if exc_type is None:
            self.close()
        else:
            self.discard()
        return False


#: slice_objstore's experiment dirs in its store, and its app id (a
#: resumed run is found by app id and name).
OBJSTORE_BUCKET = "gs://maggy-smoke"
OBJSTORE_SWEEP = OBJSTORE_BUCKET + "/objstore"
OBJSTORE_RESUME = OBJSTORE_BUCKET + "/objstore_resume"
OBJSTORE_APP_ID = "objstore_smoke"


def store_mirror(env, src, dst, skip=("checkpoints",)):
    """Copy the store's tree under ``src`` into the local ``dst`` through
    ``env``, all but the ``skip`` dirs: slice_objstore reads its run back
    from the store and holds it to slice_fork's local checks. Returns the
    files copied."""
    copied = 0
    os.makedirs(dst, exist_ok=True)
    for name in env.ls(src):
        src_path, dst_path = src + "/" + name, os.path.join(dst, name)
        if env.isdir(src_path):
            if name not in skip:
                copied += store_mirror(env, src_path, dst_path, skip)
            continue
        with env.open_file(src_path, "rb") as f, open(dst_path, "wb") as out:
            shutil.copyfileobj(f, out)
        copied += 1
    return copied


def local_gs_paths(phase_dir):
    """Local paths named ``gs:...`` (where a store path taken as a local one
    lands): in the working directory, the repo root and the default base
    dir, and anywhere under ``phase_dir``."""
    found = [os.path.join(d, "gs:") for d in (
        os.getcwd(), ROOT, os.path.join(os.path.expanduser("~"), "maggy_tpu_experiments"))
        if os.path.lexists(os.path.join(d, "gs:"))]
    for root, dirs, files in os.walk(phase_dir):
        found += [os.path.join(root, n) for n in dirs + files if n.startswith("gs:")]
    return sorted(set(found))


def objstore_resume(exp_dir, env):
    """JAX ``tests/test_gcs_env.py:85-138`` on the card: three random-search
    trials of train_mnist_ckpt (a checkpoint a step) in the store, one
    finalized trial.json torn to 17 bytes, then ``resume=True`` with six
    trials: two restored, the torn one re-run, three fresh, and the torn
    artifact whole again."""
    from maggy_tpu_torch import OptimizationConfig, experiment
    from maggy_tpu_torch.train.checkpoint import latest_checkpoint_step_env

    def run(n, incarnation):
        out_dir = fresh_dir(os.path.join(exp_dir, "resume_records", str(incarnation)))
        config = OptimizationConfig(
            name="objstore_resume", num_trials=n, optimizer="randomsearch",
            searchspace=chaos_space(), direction="max", num_workers=2, hb_interval=0.05,
            seed=5, es_policy="none", experiment_dir=OBJSTORE_RESUME, resume=incarnation > 1)
        t0 = time.perf_counter()
        result = experiment.lagom(functools.partial(train_mnist_ckpt, out_dir=out_dir), config)
        return result, read_records(out_dir), time.perf_counter() - t0

    first, records1, wall1 = run(3, 1)
    (run_name,) = env.ls(OBJSTORE_RESUME)
    run_url = OBJSTORE_RESUME + "/" + run_name
    torn = torn_id = None
    for name in env.ls(run_url):
        path = "{}/{}/trial.json".format(run_url, name)
        if env.exists(path):
            torn, torn_id = path, name
            env.dump(env.load(path)[:17], path)
            break
    second, records2, wall2 = run(6, 2)
    rerun = sorted(r["trial_id"] for r in records2)
    first_ids = sorted(r["trial_id"] for r in records1)
    restored = sorted(set(first_ids) - set(rerun))
    whole = json.loads(env.load(torn)) if torn else None
    trials = [n for n in env.ls(run_url) if env.exists("{}/{}/trial.json".format(run_url, n))]
    ckpt_steps = {n: latest_checkpoint_step_env(env, "{}/{}".format(run_url, n)) for n in trials}
    line = {"num_trials": [first["num_trials"], second["num_trials"]], "torn": torn_id,
            "restored": restored, "rerun": rerun, "walls_s": [wall1, wall2],
            "checkpoint_steps": ckpt_steps}
    problems = []
    if not (first["num_trials"] == 3 and second["num_trials"] == 6 and torn is not None
            and len(restored) == 2 and torn_id in rerun and len(rerun) == 4
            and whole and whole.get("status") == "FINALIZED" and len(trials) == 6
            and set(ckpt_steps.values()) == {CHAOS_CKPT_STEPS - 1}):
        problems.append("resume: {}, torn artifact now {}".format(line, whole))
    return line, problems


def phase_slice_objstore(exp_dir, smi):
    """slice_fork's sweep with its whole experiment dir in an object store:
    ``GCSEnv`` over ``SmokeStore`` (``EnvSing.set_instance``), then the
    object-store resume; see the module docstring."""
    import importlib.util

    from maggy_tpu_torch.core.environment import EnvSing, GCSEnv
    from maggy_tpu_torch.train import clear_warm, warm

    t_phase = time.perf_counter()
    fresh_dir(exp_dir)
    free = shutil.disk_usage(exp_dir).free
    if free < FORK_MIN_FREE_BYTES:
        raise AssertionError("slice_objstore needs {:.0f} GB free for its store; {} has "
                             "{:.1f} GB".format(FORK_MIN_FREE_BYTES / 1e9, exp_dir, free / 1e9))
    gc.collect()
    torch.cuda.empty_cache()
    store = SmokeStore(os.path.join(exp_dir, "store"))
    env = GCSEnv(OBJSTORE_BUCKET, fs=store)
    refused = collections.Counter()
    open_file = env.open_file

    def counted_open(path, mode="r"):
        # GCSEnv refuses an append before the store sees it: counted here.
        try:
            return open_file(path, mode)
        except io.UnsupportedOperation:
            refused[path.rsplit("/", 1)[-1]] += 1
            raise

    env.open_file = counted_open
    app_id = os.environ.get("MAGGY_TPU_APP_ID")
    os.environ["MAGGY_TPU_APP_ID"] = OBJSTORE_APP_ID
    EnvSing.set_instance(env)
    try:
        before = warm.counters()
        result, wall, records, launches = bert_asha_sweep(
            exp_dir, "thread", train=train_bert_fork, experiment_dir=OBJSTORE_SWEEP,
            scalars=True)
        join_fork_gc()
        sweep_ops, puts = store.snapshot()
        t0 = time.perf_counter()
        mirrored = store_mirror(env, OBJSTORE_SWEEP, os.path.join(exp_dir, "exp"))
        read_back_s = time.perf_counter() - t0
        (run_name,) = env.ls(OBJSTORE_SWEEP)
        run_url = OBJSTORE_SWEEP + "/" + run_name
        trials, promoted, total_steps, expected = check_bert_sweep(
            "slice_objstore", result, exp_dir, records, launches)
        telemetry = journal_check("slice_objstore", os.path.join(exp_dir, "exp"), result)
        reading = fork_reading(telemetry)
        reading_warm = warm_reading("slice_objstore", telemetry, before)
        CAPTURED["bert_base_objstore"] = reading_warm["captured"]
        clear_warm()
        forks, gced, problems = fork_gates(
            trials, records, telemetry, reading,
            lambda tid: env.isdir("{}/{}/checkpoints".format(run_url, tid)))
        order = {p: i for i, p in enumerate(puts)}
        markers = {}
        for tid, fork in forks.items():
            ckpt = "{}/{}/checkpoints/".format(run_url, tid)
            marker = ckpt + ".fork_complete.{}".format(fork["step"])
            state = ckpt + "{}/state.pt".format(fork["step"])
            markers[tid] = marker in order
            if not (marker in order and state in order and order[state] < order[marker]):
                problems.append("fork {} at step {}: staged object {}, marker {}".format(
                    tid, fork["step"], state in order, marker in order))
        tmp_objects = [p for p in puts + store.objects() if ".tmp." in p or ".fork_tmp" in p]
        if tmp_objects:
            problems.append("tmp objects in the store: {}".format(tmp_objects[:5]))
        if not refused.get("telemetry.jsonl") or sweep_ops.get("append_refused"):
            problems.append("appends refused by GCSEnv {}, by the store {}: want the "
                            "journal's refused and none reaching the store".format(
                                dict(refused), sweep_ops.get("append_refused")))
        suggested = sum(1 for e in telemetry["_events"]
                        if e["ev"] == "suggest" and e["source"] == "prefetch")
        invalidated = sum(e["n"] for e in telemetry["_events"]
                          if e["ev"] == "prefetch_invalidated")
        pipe = result["pipeline"]
        if pipe["prefetch_hits"] or not pipe["prefetch"] or suggested - invalidated <= 0:
            problems.append("inline FINAL path: {} hits on FINAL replies, prefetch {}, {} "
                            "prefetched less {} invalidated".format(
                                pipe["prefetch_hits"], pipe["prefetch"], suggested, invalidated))
        if not env.exists(run_url + "/.summary.json"):
            problems.append("no .summary.json in the store")
        tb = tensorboard_check("slice_objstore", os.path.join(exp_dir, "exp"), records,
                               bert_asha_space(), traced=False)
        resume_line, resume_problems = objstore_resume(exp_dir, env)
        problems += resume_problems
    finally:
        EnvSing.reset()
        if app_id is None:
            os.environ.pop("MAGGY_TPU_APP_ID", None)
        else:
            os.environ["MAGGY_TPU_APP_ID"] = app_id
    local = local_gs_paths(exp_dir)
    if local:
        problems.append("local gs: paths {}".format(local))
    ops, _ = store.snapshot()
    line = {"device": smi, "trials_finished": len(trials), "promoted": promoted,
            "forks": len(forks), "fork_markers": markers, "early_stopped": result["early_stopped"],
            "best_val": result["best_val"], "steps": total_steps, "launches": launches,
            "expected_launches_each": expected, "sweep_wall_s": wall, "ckpt_gc": len(gced),
            "store_ops_sweep": sweep_ops, "store_ops_phase": ops,
            "appends_refused": dict(refused), "objects_left": len(
                store.objects()), "tmp_objects": len(tmp_objects), "local_gs_paths": local,
            "mirrored_files": mirrored, "read_back_s": read_back_s,
            "absent_modules": {m: importlib.util.find_spec(m) is None
                               for m in ("fsspec", "gcsfs")},
            "prefetched_served": suggested - invalidated, **reading, "warm": reading_warm,
            "slice_fork": READINGS.get("slice_fork"), "tensorboard": tb, "resume": resume_line,
            "pipeline": pipeline_summary(pipe), "telemetry": public(telemetry),
            "phase_s": time.perf_counter() - t_phase}
    emit("slice_objstore", **line)
    if problems:
        raise AssertionError("slice_objstore: {}".format("; ".join(problems)))
    shutil.rmtree(exp_dir)
    return launches


def phase_slice_pbt(exp_dir):
    """examples/pbt_sweep.py on the card, one segment preempted gracefully
    through the driver (reached with experiment.lagom_driver, the entry
    point lagom itself calls)."""
    from maggy_tpu_torch import OptimizationConfig, Searchspace, experiment, util
    from maggy_tpu_torch.core.environment import EnvSing
    from maggy_tpu_torch.optimizers import PBT
    from maggy_tpu_torch.train import clear_warm, warm

    fresh_dir(exp_dir)
    gc.collect()
    torch.cuda.empty_cache()
    sp = Searchspace(lr=("DOUBLE", [1e-4, 3e-2]), wd=("DOUBLE", [0.0, 0.1]))
    opt = PBT(population=6, generations=4, seed=0)
    config = OptimizationConfig(
        name="pbt_sweep", num_trials=opt.schedule_size(), optimizer=opt, searchspace=sp,
        direction="max", num_workers=3, es_policy="none", seed=0, hb_interval=0.1,
        experiment_dir=exp_dir)
    preempt = PreemptOnce()
    app_id = "pbt_sweep"
    driver = experiment.lagom_driver(config, app_id,
                                     util.claim_run_id(exp_dir, app_id, EnvSing.get_instance()))
    preempted = {}

    def timer():
        # Waits for the claim, preempts that runner's trial, then lets the
        # segment go on (each of its steps now reports, and may stop).
        if preempt.claimed.wait(300) and preempt.detail:
            preempted["trial_id"] = driver.preempt_partition(preempt.detail["partition"])
            preempted["at"] = time.time()
            preempt.armed.set()

    thread = threading.Thread(target=timer, daemon=True, name="preempt-timer")
    thread.start()
    before = warm.counters()
    t0 = time.perf_counter()
    result = driver.run_experiment(functools.partial(train_pbt, preempt=preempt))
    wall = time.perf_counter() - t0
    preempt.claimed.set()  # releases the timer if no segment claimed
    thread.join(10)
    trials = read_trials(exp_dir)
    failed = [t["id"] for t in trials if t["status"] != "FINALIZED"]
    if failed:
        raise AssertionError("slice_pbt: segments {} failed; runner logs:\n{}".format(
            failed, runner_logs(exp_dir)))
    telemetry = journal_check("slice_pbt", exp_dir, result)
    reading_warm = warm_reading("slice_pbt", telemetry, before)
    clear_warm()
    events = [e for e in telemetry["_events"] if e["ev"] == "trial"]
    forks = {e["trial"]: e for e in events if e["phase"] == "forked_from"}
    by_id = {t["id"]: t for t in trials}
    problems = []
    if not (len(trials) == result["num_trials"] == 24
            and all(t["status"] == "FINALIZED" for t in trials)
            and math.isfinite(result["best_val"])):
        problems.append("{} trials ({} finalized), result {}".format(
            len(trials), sum(t["status"] == "FINALIZED" for t in trials), result["num_trials"]))
    def newest_step(tid):
        # A segment saves its generation, unless a fork staged a later step
        # into its dir first: then its save is skipped and the staged step
        # stays its newest (orbax's rule, ROADMAP queue 3 item 7).
        return max(by_id[tid]["params"]["generation"], forks.get(tid, {}).get("step", -1))

    for t in trials:
        parent = t["info_dict"].get("parent")
        if t["params"]["generation"] >= 1:
            fork = forks.get(t["id"])
            want = newest_step(parent) if parent in by_id else None
            if fork is None or fork.get("parent") != parent or fork.get("step") != want:
                problems.append("segment {} (parent {}) not forked at step {}: {}".format(
                    t["id"], parent, want, fork))
    victim = preempt.detail.get("trial_id")
    chain = [e for e in events if e["trial"] == victim and e["phase"] in (
        "preempt_requested", "preempted", "requeued", "resumed", "finalized")]
    phases = [e["phase"] for e in chain]
    fork_step = forks.get(victim, {}).get("step")
    ack = next((e for e in chain if e["phase"] == "preempted"), {})
    resumed = next((e for e in chain if e["phase"] == "resumed"), {})
    if not (victim and preempted.get("trial_id") == victim
            and phases == ["preempt_requested", "preempted", "requeued", "resumed", "finalized"]
            and ack.get("checkpointed") == (ack.get("step") is not None)
            and ack.get("step") in (None, fork_step)
            and resumed.get("from_step") == fork_step is not None
            and result.get("preemptions") == 1):
        problems.append("preemption of {} (claimed by {}): chain {}, fork step {}, "
                        "preemptions {}".format(preempted.get("trial_id"), victim, chain,
                                                fork_step, result.get("preemptions")))
    types = [t["info_dict"]["sample_type"] for t in trials]
    # Segments that forked a step at or past their own generation: their
    # own save was skipped and they pass the staged copy on.
    kept_staged = sum(1 for tid, f in forks.items()
                      if tid in by_id and f["step"] >= by_id[tid]["params"]["generation"])
    emit("slice_pbt", trials_finished=len(trials), forks=len(forks),
         saves_skipped_for_staged_step=kept_staged,
         sample_types={k: types.count(k) for k in sorted(set(types))},
         best_val=result["best_val"], best_hp=result["best_hp"], sweep_wall_s=wall,
         preemptions=result.get("preemptions"), preempted=preempt.detail,
         preemption_chain=[{k: e.get(k) for k in ("phase", "t", "partition", "step",
                                                  "checkpointed", "reason", "from_step")}
                           for e in chain],
         **fork_reading(telemetry), warm=reading_warm,
         pipeline=pipeline_summary(result["pipeline"]), telemetry=public(telemetry))
    if problems:
        raise AssertionError("slice_pbt: {}".format("; ".join(problems)))


# ------------------------------------------------------------- slice_resume


def resume_dirs(sweep):
    """(root, experiment dir, run dir) of a slice_resume sweep: both
    incarnations run under app id ``sweep``, run 0."""
    root = os.path.join(RESUME_ROOT, sweep)
    exp = os.path.join(root, "exp")
    return root, exp, os.path.join(exp, sweep + "_0")


def resume_config(sweep, incarnation):
    """(config, train function, records dir) of one incarnation of a
    slice_resume sweep; the second resumes the first's run."""
    from maggy_tpu_torch import OptimizationConfig, Searchspace
    from maggy_tpu_torch.optimizers import Asha, RandomSearch

    root, exp, _ = resume_dirs(sweep)
    out_dir = os.path.join(root, "records", str(incarnation))
    os.makedirs(out_dir, exist_ok=True)
    resume = incarnation > 1
    if sweep == "bert_base_resume":
        # The slice_fork sweep, with an unseeded ASHA: a seeded one resumed
        # draws its pre-crash rung-0 configs again (ROADMAP queue 3 item 8),
        # and "no finalized trial runs again" would then test nothing.
        sp = Searchspace(lr=("DOUBLE_LOG", [1e-5, 1e-3]), warmup_frac=("DOUBLE", [0.0, 0.3]))
        config = OptimizationConfig(
            name=sweep, num_trials=9,
            optimizer=Asha(reduction_factor=3, resource_min=1, resource_max=9, seed=None),
            searchspace=sp, direction="max", num_workers=2, es_policy="median", es_min=3,
            hb_interval=0.1, hb_loss_timeout=RESUME_LOSS_TIMEOUT_S, seed=0,
            experiment_dir=exp, resume=resume)
        return config, functools.partial(train_bert_fork, out_dir=out_dir), out_dir
    markers = os.path.join(root, "markers")
    os.makedirs(markers, exist_ok=True)
    sp = Searchspace(lr=("DOUBLE_LOG", [1e-4, 3e-2]), batch=("DISCRETE", MNIST_BATCHES))
    config = OptimizationConfig(
        name=sweep, optimizer=RandomSearch(seed=7, pruner="hyperband",
                                           pruner_kwargs=RESUME_HYPERBAND),
        searchspace=sp, direction="max", num_workers=2, hb_interval=0.1, es_policy="none",
        seed=7, experiment_dir=exp, resume=resume)
    return config, functools.partial(train_mnist, out_dir=out_dir, marker_dir=markers,
                                     steps_per_budget=MNIST_RESUME_STEPS_PER_BUDGET), out_dir


def resume_child(sweep, incarnation):
    """One incarnation of a slice_resume sweep in a process of its own
    (``chip_smoke.py --resume-child <sweep> <incarnation>``): the sweep
    through experiment.lagom, the launch counters zeroed just before and
    read just after; prints one JSON line with its launches, its steps and
    first steps from the per-trial records, its wall time and its peak
    device memory."""
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    from maggy_tpu_torch import experiment
    from maggy_tpu_torch.ops import attention as A
    from maggy_tpu_torch.train import warm

    full_fp32()
    config, train, out_dir = resume_config(sweep, incarnation)
    A.reset_launch_counts()
    t0 = time.perf_counter()
    result = experiment.lagom(train, config)
    wall = time.perf_counter() - t0
    launches = A.launch_counts()
    records = read_records(out_dir)
    print(json.dumps({
        "sweep": sweep, "incarnation": incarnation, "pid": os.getpid(), "wall_s": wall,
        "launches": launches, "steps": sum(r["steps"] for r in records),
        "first_step": {r["trial_id"]: r["first_step"] for r in records},
        "trial_steps": {r["trial_id"]: r["steps"] for r in records},
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "warm": warm.counters(), "num_trials": result["num_trials"]}), flush=True)


def log_tail(path, n=60):
    with open(path, errors="replace") as f:
        return "\n".join(f.read().splitlines()[-n:])


def spawn_child(sweep, incarnation, log_path):
    env = dict(os.environ, MAGGY_TPU_APP_ID=sweep)
    with open(log_path, "w") as log:
        return subprocess.Popen([sys.executable, CHILD_SCRIPT, "--resume-child", sweep,
                                 str(incarnation)], cwd=ROOT, env=env, stdout=log,
                                stderr=subprocess.STDOUT)


def on_disk(run_dir):
    """What the sweep has made durable: its finalized trial.json records by
    id, and its journal's events by trial."""
    from maggy_tpu_torch.telemetry import read_events

    finals = {}
    for path in glob.glob(os.path.join(run_dir, "*", "trial.json")):
        with open(path) as f:
            trial = json.load(f)
        if trial["status"] == "FINALIZED":
            finals[trial["id"]] = trial
    journal = os.path.join(run_dir, "telemetry.jsonl")
    events = read_events(journal) if os.path.exists(journal) else []
    by_trial = {}
    for e in events:
        if e["ev"] == "trial":
            by_trial.setdefault(e["trial"], []).append(e)
    return finals, events, by_trial


def in_flight(by_trial):
    """The journal's trials queued and not finalized: {id: (held, fork)},
    held = a partition held it (its last attempt edge is assigned or
    running), fork = its queued edge's forked_from."""
    out = {}
    for tid, evs in by_trial.items():
        phases = [e["phase"] for e in evs]
        if "queued" not in phases or "finalized" in phases:
            continue
        attempt = [p for p in phases if p in ("assigned", "running", "requeued", "lost",
                                              "preempted")]
        queued = next(e for e in evs if e["phase"] == "queued")
        out[tid] = (bool(attempt) and attempt[-1] in ("assigned", "running"),
                    (queued.get("info") or {}).get("forked_from"))
    return out


def kill_mid_flight(sweep, min_finals):
    """Incarnation 1, killed with SIGKILL once the run dir holds at least
    ``min_finals`` finalized trials and the flushed journal a trial running
    and not finalized, at a moment with a fork running if one comes before
    the sweep is half done. The parent only reads files meanwhile."""
    root, _, run_dir = resume_dirs(sweep)
    log = os.path.join(root, "incarnation_1.log")
    t_spawn = time.time()
    proc = spawn_child(sweep, 1, log)
    try:
        deadline = time.monotonic() + RESUME_KILL_DEADLINE_S
        while True:
            if proc.poll() is not None:
                raise AssertionError("{}: incarnation 1 ended (rc {}) before its kill:\n{}".format(
                    sweep, proc.returncode, log_tail(log)))
            finals, _, by_trial = on_disk(run_dir)
            running = {tid: fork for tid, (held, fork) in in_flight(by_trial).items()
                       if any(e["phase"] == "running" for e in by_trial[tid])}
            if len(finals) >= min_finals and running and (
                    any(running.values()) or len(finals) >= min_finals + 3):
                break
            if time.monotonic() > deadline:
                raise AssertionError("{}: no kill point within {} s:\n{}".format(
                    sweep, RESUME_KILL_DEADLINE_S, log_tail(log)))
            time.sleep(0.05)
        proc.send_signal(signal.SIGKILL)
        proc.wait(60)
        t_kill = time.time()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(60)
    if proc.returncode != -signal.SIGKILL:
        raise AssertionError("{}: incarnation 1 exited {}, not by SIGKILL".format(
            sweep, proc.returncode))
    finals, events, by_trial = on_disk(run_dir)
    return {"wall_s": t_kill - t_spawn, "t_kill": t_kill, "finals": finals,
            "in_flight": in_flight(by_trial), "journal_events": len(events),
            "torn_lines_at_kill": events.torn_lines if events else 0,
            "pruner_state": os.path.exists(os.path.join(run_dir, ".pruner_state.json"))}


def resume_run(sweep):
    """Incarnation 2, resumed in a new process, run to its end: its wall
    time (spawn to exit) and its JSON line."""
    root = resume_dirs(sweep)[0]
    log = os.path.join(root, "incarnation_2.log")
    t_spawn = time.time()
    proc = spawn_child(sweep, 2, log)
    try:
        rc = proc.wait(RESUME_CHILD_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        raise AssertionError("{}: incarnation 2 ran past {} s:\n{}".format(
            sweep, RESUME_CHILD_TIMEOUT_S, log_tail(log)))
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(60)
    if rc != 0:
        raise AssertionError("{}: incarnation 2 exited {}:\n{}".format(sweep, rc, log_tail(log)))
    lines = [line for line in open(log).read().splitlines() if line.startswith('{"sweep"')]
    return t_spawn, time.time() - t_spawn, json.loads(lines[-1])


def resume_checks(sweep, kill, t_spawn2, wall2, child):
    """The checks both slice_resume sweeps share, on the journal of both
    incarnations; returns (problems, reading, trials, telemetry, result)."""
    _, exp, run_dir = resume_dirs(sweep)
    with open(os.path.join(run_dir, "result.json")) as f:
        result = json.load(f)
    trials = read_trials(exp)
    telemetry = journal_check(sweep, exp, result)
    events = telemetry["_events"]
    problems = []
    epochs = [e["epoch"] for e in events if e["ev"] == "driver_epoch"]
    markers = sorted(n for n in os.listdir(run_dir) if n.startswith(".driver_epoch."))
    if epochs != [1, 2] or markers != [".driver_epoch.1", ".driver_epoch.2"]:
        problems.append("driver epochs {}, markers {}".format(epochs, markers))
    resumed = [e for e in events if e["ev"] == "experiment" and e.get("phase") == "resumed"]
    recovered = [e for e in events if e["ev"] == "experiment" and e.get("phase") == "recovered"]
    if len(resumed) != 1 or len(recovered) != 1 or recovered[0]["inflight"] < 1:
        problems.append("resumed {}, recovered {}".format(resumed, recovered))
    seam = next((i for i, e in enumerate(events)
                 if e["ev"] == "driver_epoch" and e["epoch"] == 2), len(events) - 1)
    post = [e for e in events[seam:] if e["ev"] == "trial"]
    rerun = sorted(tid for tid in kill["finals"]
                   if any(e["trial"] == tid and e["phase"] == "running" for e in post))
    if rerun:
        problems.append("trials finalized before the kill ran again: {}".format(rerun))
    requeues = {}
    for e in post:
        if e["phase"] == "requeued":
            requeues.setdefault(e["trial"], []).append(e.get("reason"))
    for tid, (held, _) in kill["in_flight"].items():
        if tid in kill["finals"]:
            # Its trial.json landed before the kill and its finalized edge
            # did not (the FINAL's journal barrier comes after the write):
            # the resume closes the edge, stamped at the trial's finish, and
            # neither requeues nor re-runs it (core/driver/recovery.py).
            closed = [e for e in post if e["trial"] == tid and e["phase"] == "finalized"]
            if len(closed) != 1 or closed[0]["t"] > kill["t_kill"] or tid in requeues:
                problems.append("trial {} finalized before the kill but not closed at the "
                                "resume: finalized edges {}, requeues {}".format(
                                    tid, [e["t"] for e in closed], requeues.get(tid)))
            continue
        want = 1 if held else 0
        reasons = requeues.get(tid, [])
        if len(reasons) != want or not set(reasons) <= {"blacklist", "heartbeat_loss"} or \
                not any(e["trial"] == tid and e["phase"] == "finalized" for e in post):
            problems.append("in-flight trial {} (held {}): requeues {}, finalized after the "
                            "resume: {}".format(tid, held, reasons, any(
                                e["trial"] == tid and e["phase"] == "finalized" for e in post)))
    if not all(t["status"] == "FINALIZED" for t in trials):
        problems.append("{} trials, {} finalized".format(
            len(trials), sum(t["status"] == "FINALIZED" for t in trials)))
    if result["early_stopped"] != sum(t["early_stop"] for t in trials):
        problems.append("early_stopped {} against {} early-stopped trials".format(
            result["early_stopped"], sum(t["early_stop"] for t in trials)))
    first_assigned = next((e["t"] for e in post if e["phase"] == "assigned"), None)
    reasons = [r for rs in requeues.values() for r in rs]
    rec = recovered[0] if recovered else {}
    reading = {
        "incarnation_wall_s": [kill["wall_s"], wall2],
        "incarnation_2_lagom_wall_s": child["wall_s"],
        "resume_to_first_assigned_s": {
            "process": None if first_assigned is None else first_assigned - t_spawn2,
            "driver": None if first_assigned is None else first_assigned - events[seam]["t"]},
        "kill_to_resume_s": t_spawn2 - kill["t_kill"],
        "restored": {"events": resumed[0].get("restored_events") if resumed else None,
                     "finalized": rec.get("finalized")},
        "recovered": {k: rec.get(k) for k in ("inflight", "held_partitions", "backlogged",
                                             "recovered_partitions", "forks")},
        "requeued": {r: reasons.count(r) for r in sorted(set(reasons))},
        "adopted": sum(1 for e in events if e["ev"] == "runner" and e.get("phase") == "adopted"),
        "finalized_before_kill": len(kill["finals"]),
        "in_flight_at_kill": len(kill["in_flight"]),
        "torn_lines_at_kill": kill["torn_lines_at_kill"],
        "peak_mem_gb_incarnation_2": child["peak_mem_gb"],
        "warm": warm_reading(sweep, telemetry, must_capture=False),
        "warm_incarnation_2": child["warm"],
    }
    return problems, reading, trials, telemetry, result


def asha_ladder(trials, events):
    """The ASHA(3, 1, 9) ladder of a sweep: (trials by rung, problems). Each
    promoted trial's parent finalized one rung below and was promoted once;
    a top-rung trial finalized; no rung-0 trial was queued after the first
    top-rung FINAL (ASHA is exhausted then and draws no more). So all 9
    rung-0 samples run unless the top rung finished first, which an
    interrupted sweep whose resumed forks finish early can reach (13 trials
    in the uninterrupted order)."""
    by_id = {t["id"]: t for t in trials}
    rung = {tid: RUNG_BUDGETS.index(int(t["params"]["budget"])) for tid, t in by_id.items()}
    by_rung = [sum(1 for r in rung.values() if r == k) for k in range(len(RUNG_BUDGETS))]
    problems = []
    promoted = [t for t in trials if rung[t["id"]] > 0]
    parents = [t["info_dict"].get("parent") for t in promoted]
    orphans = [t["id"] for t in promoted
               if rung.get(t["info_dict"].get("parent")) != rung[t["id"]] - 1]
    if orphans or len(parents) != len(set(parents)):
        problems.append("ladder {}: promotions {} without a parent a rung below, parents "
                        "{}".format(by_rung, orphans, parents))
    top = [e["t"] for e in events if e["ev"] == "trial" and e["phase"] == "finalized"
           and rung.get(e["trial"]) == len(RUNG_BUDGETS) - 1]
    late = [e["trial"] for e in events if e["ev"] == "trial" and e["phase"] == "queued"
            and rung.get(e["trial"]) == 0 and top and e["t"] > min(top)]
    if not top or by_rung[0] > 9 or late:
        problems.append("ladder {}: top rung finalized {} times, rung-0 trials queued after "
                        "it: {}".format(by_rung, len(top), late))
    return by_rung, problems


def phase_slice_resume():
    """Two sweeps killed with SIGKILL mid-flight and resumed in a new
    process; the parent only watches, kills and checks."""
    from maggy_tpu_torch.pruner.hyperband import Hyperband

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    # (a) The slice_fork sweep, killed after its first rung-0 FINALs.
    sweep = "bert_base_resume"
    root = fresh_dir(resume_dirs(sweep)[0])
    free = shutil.disk_usage(root).free
    if free < FORK_MIN_FREE_BYTES:
        raise AssertionError("slice_resume needs {:.0f} GB free for its checkpoints; {} has "
                             "{:.1f} GB".format(FORK_MIN_FREE_BYTES / 1e9, root, free / 1e9))
    with DiskPeak(root) as disk:
        kill = kill_mid_flight(sweep, min_finals=4)
        t_spawn2, wall2, child = resume_run(sweep)
    problems, reading, trials, telemetry, result = resume_checks(
        sweep, kill, t_spawn2, wall2, child)
    by_rung, ladder = asha_ladder(trials, telemetry["_events"])
    problems += ladder
    from maggy_tpu_torch.models import BertConfig

    layers = BertConfig.base().num_layers
    expected = layers * child["steps"]
    if any(n != expected for n in child["launches"].values()) or expected == 0:
        problems.append("incarnation 2's launches {} != {} layers x {} steps".format(
            child["launches"], layers, child["steps"]))
    events = telemetry["_events"]
    seam = next(i for i, e in enumerate(events) if e["ev"] == "driver_epoch" and e["epoch"] == 2)
    post = [e for e in events[seam:] if e["ev"] == "trial"]
    by_id = {t["id"]: t for t in trials}
    forks = {e["trial"]: e for e in events if e["ev"] == "trial" and e["phase"] == "forked_from"}
    queued_after = {e["trial"] for e in post if e["phase"] == "queued"}
    # Promotions the resumed incarnation made of parents that saved before
    # the kill fork them at their last step and train from the step after.
    promoted_forks = []
    for tid in sorted(queued_after):
        parent = by_id[tid]["info_dict"].get("parent")
        if parent is None or parent not in kill["finals"] or kill["finals"][parent]["early_stop"]:
            continue
        want = int(kill["finals"][parent]["params"]["budget"]) * STEPS_PER_BUDGET - 1
        fork = forks.get(tid, {})
        promoted_forks.append({"trial": tid, "parent": parent, "step": fork.get("step"),
                               "first_step": child["first_step"].get(tid)})
        if fork.get("parent") != parent or fork.get("step") != want or \
                child["first_step"].get(tid) != want + 1:
            problems.append("promotion {} of {} (saved before the kill): fork {}, first step "
                            "{}, want step {}".format(tid, parent, fork,
                                                      child["first_step"].get(tid), want))
    # A fork in flight at the kill resumes from its fork step.
    resumed_forks = []
    for tid, (_, fork) in kill["in_flight"].items():
        if not fork:
            continue
        total = int(by_id[tid]["params"]["budget"]) * STEPS_PER_BUDGET
        again = [e for e in post if e["trial"] == tid and e["phase"] == "resumed"]
        first = child["first_step"].get(tid)
        resumed_forks.append({"trial": tid, "fork_step": fork["step"], "first_step": first,
                              "resumed": [e.get("from_step") for e in again]})
        if [e.get("from_step") for e in again] != [fork["step"]] or \
                first not in (fork["step"] + 1, total):
            problems.append("fork {} in flight at the kill: resumed {}, first step {}, fork "
                            "step {}".format(tid, again, first, fork["step"]))
    if reading["recovered"]["forks"] != len(resumed_forks):
        problems.append("recovery counted {} forks, {} were in flight".format(
            reading["recovered"]["forks"], len(resumed_forks)))
    rerun_steps = sum(child["trial_steps"].get(tid, 0) for tid in kill["in_flight"])
    emit("slice_resume/" + sweep, **reading, trials_finished=len(trials),
         early_stopped=result["early_stopped"],
         early_stopped_before_kill=sum(t["early_stop"] for t in kill["finals"].values()),
         trials_by_rung=by_rung,
         best_val=result["best_val"], steps_incarnation_2=child["steps"],
         launches=child["launches"], expected_launches_each=expected,
         fork_in_flight_at_kill=bool(resumed_forks), forks_resumed=resumed_forks,
         promotions_forked_after_resume=promoted_forks,
         rework_s=telemetry["goodput"]["buckets_s"].get("rework", 0.0),
         rerun_steps=rerun_steps, disk_peak_bytes=disk.peak,
         goodput=telemetry["goodput"], telemetry=public(telemetry))
    if problems:
        raise AssertionError("slice_resume/{}: {}".format(sweep, "; ".join(problems)))
    shutil.rmtree(root)
    launches = child["launches"]
    CAPTURED["bert_base_resume"] = (child["warm"]["graph_replays"] > 0
                                    and not child["warm"]["graph_failures"])

    # (b) bench.py's MNIST model under Hyperband: the bracket state.
    sweep = "mnist_hyperband_resume"
    root = fresh_dir(resume_dirs(sweep)[0])
    kill = kill_mid_flight(sweep, min_finals=4)
    markers_at_kill = set(os.listdir(os.path.join(root, "markers")))
    t_spawn2, wall2, child = resume_run(sweep)
    problems, reading, trials, telemetry, result = resume_checks(sweep, kill, t_spawn2, wall2,
                                                                 child)
    full = Hyperband(trial_metric_getter=dict, **RESUME_HYPERBAND).num_trials()
    if not kill["pruner_state"]:
        problems.append("no .pruner_state.json at the kill")

    def marker(t):
        p = t["params"]
        return "{:.10f}_{}_{}".format(p["lr"], p["batch"], p["budget"])

    sizes = {m: os.path.getsize(os.path.join(root, "markers", m))
             for m in os.listdir(os.path.join(root, "markers"))}
    twice = {m for m, n in sizes.items() if n > 1}
    before = {marker(t) for t in kill["finals"].values()}
    flight = {marker(t) for t in trials if t["id"] in kill["in_flight"]}
    # Every slot of the schedule ran; the trials in flight at the kill ran
    # once more each, and their dropped slots were issued again, as in the
    # JAX package (ROADMAP queue 3 item 10).
    if len(sizes) < full or result["num_trials"] != full + reading["recovered"]["inflight"]:
        problems.append("{} configs ran, {} trials in result.json, for {} slots and {} "
                        "recovered".format(len(sizes), result["num_trials"], full,
                                           reading["recovered"]["inflight"]))
    if twice & before or not twice <= flight & markers_at_kill or len(twice) > 2 or \
            max(sizes.values()) > 2:
        problems.append("ran twice: {}; finalized before the kill {}; in flight {}".format(
            sorted(twice), len(before), sorted(flight)))
    emit("slice_resume/" + sweep, **reading, trials_finished=len(trials), slots=full,
         configs_run=len(sizes), ran_twice=len(twice), best_val=result["best_val"],
         steps_incarnation_2=child["steps"], pruner_state_at_kill=kill["pruner_state"],
         goodput=telemetry["goodput"], telemetry=public(telemetry))
    if problems:
        raise AssertionError("slice_resume/{}: {}".format(sweep, "; ".join(problems)))
    shutil.rmtree(root)
    return launches


# ---------------------------------------------------------------- slice_warm


def train_bert_ab(lr, reporter, out_dir, lanes=None):
    """One trial of slice_warm's bert_base arm: BERT-base on the slice's
    key-padded batches under ``swept_transform(adamw, learning_rate=lr)`` (a
    constant rate: every trial of the sweep is one program), AB_BERT_STEPS
    steps, a heartbeat every REPORT_EVERY steps. Given ``lanes`` (slice_lanes'
    sweep with vmap_lanes), the block's lanes train as one VmapTrainer."""
    from maggy_tpu_torch.models import BertEncoder
    from maggy_tpu_torch.train import Trainer, adamw, swept_transform

    record = TrialRecord(out_dir, reporter)
    full_fp32()
    cfg, batch = bert_data()
    if lanes is not None:
        return train_lanes(lanes_trainer(BertEncoder(cfg, device="meta"), adamw, lanes),
                           batch, AB_BERT_STEPS, REPORT_EVERY, reporter, lanes, record)
    trainer = Trainer(BertEncoder(cfg, device="meta"), swept_transform(adamw, learning_rate=lr),
                      labels_loss, device=DEVICE).init(seed=0)
    with record:
        for i in range(AB_BERT_STEPS):
            loss = trainer.step(batch(i))
            record.steps += 1
            if i % REPORT_EVERY == REPORT_EVERY - 1:
                reporter.broadcast(-loss, step=i)
    return {"metric": -float(loss)}


def compile_ab_arm(model, arm, warm_on, exp_root, train, space, lanes=None):
    """One arm of bench.py's run_compile_ab (``bench.py:259-318``): the
    fixed-shape RandomSearch(seed 11) sweep of AB_TRIALS trials over
    ``space`` on one thread runner, es_policy none, ``warm_start=warm_on``,
    from an empty warm cache. Returns the arm's line and its per-trial
    final losses by lr. With ``lanes`` (slice_lanes) the sweep runs with
    vmap_lanes=lanes: its hits and misses depend on how blocks assemble, so
    instead every step but each unit's first must replay a graph."""
    from maggy_tpu_torch import OptimizationConfig, Searchspace, experiment
    from maggy_tpu_torch.ops import attention as A
    from maggy_tpu_torch.train import clear_warm, warm

    name = "{}/{}/{}".format("slice_lanes" if lanes else "slice_warm", model, arm)
    exp_dir = fresh_dir(os.path.join(exp_root, model, arm))
    out_dir = fresh_dir(os.path.join(exp_dir, "records"))
    clear_warm()
    config = OptimizationConfig(
        name="bench_ab_{}".format(arm), num_trials=AB_TRIALS, optimizer="randomsearch",
        searchspace=Searchspace(**space), direction="max", num_workers=1, hb_interval=0.1,
        es_policy="none", seed=11, warm_start=warm_on,
        experiment_dir=os.path.join(exp_dir, "exp"), **({"vmap_lanes": lanes} if lanes else {}))
    before = warm.counters()
    A.reset_launch_counts()
    t0 = time.perf_counter()
    result = experiment.lagom(functools.partial(train, out_dir=out_dir), config)
    wall = time.perf_counter() - t0
    launches = A.launch_counts()
    telemetry = journal_check(name, os.path.join(exp_dir, "exp"), result)
    reading = warm_reading(name, telemetry, before, must_capture=warm_on)
    clear_warm()
    trials = read_trials(os.path.join(exp_dir, "exp"))
    records = read_records(out_dir)
    comp = telemetry["_compile"]
    warm_p50 = (comp.get("ttfm_warm") or {}).get("median_ms")
    cold_p50 = (comp.get("ttfm_cold") or {}).get("median_ms")
    steps = sum(r["steps"] for r in records)
    line = {"wall_s": wall, "trials": len(trials), "steps": steps,
            "warm_hits": comp.get("warm_hits", 0), "warm_misses": comp.get("warm_misses", 0),
            "ttfm_warm": comp.get("ttfm_warm") or {}, "ttfm_cold": comp.get("ttfm_cold") or {},
            "gate": {"warm_ttfm_p50_ms": warm_p50, "cold_ttfm_p50_ms": cold_p50,
                     "ratio": cold_p50 / warm_p50 if warm_p50 and cold_p50 else None},
            "init_ms": comp.get("init_ms"), "compile_ms": comp.get("compile_ms"),
            "first_step_ms": comp.get("first_step_ms"),
            "step_ms_in_sweep_median": float(np.median([r["step_ms"] for r in records])),
            "goodput_s": telemetry["goodput"]["buckets_s"],
            "goodput_shares": telemetry["goodput"]["shares"], "warm": reading}
    if model == "bert_base":
        line["launches"] = launches
    problems = []
    if not (len(trials) == result["num_trials"] == AB_TRIALS
            and all(t["status"] == "FINALIZED" for t in trials)):
        problems.append("{} trials finalized of {}".format(len(trials), AB_TRIALS))
    want = (AB_TRIALS - 1, 1) if warm_on else (0, AB_TRIALS)
    if lanes:
        replayed_after_warmup(name, reading, steps)
    elif (line["warm_hits"], line["warm_misses"]) != want:
        problems.append("warm hits/misses {}/{}, want {}/{}".format(
            line["warm_hits"], line["warm_misses"], *want))
    if not warm_on and (reading["graph_replays"] or reading["graph_captures"]):
        problems.append("the cold arm replayed graphs: {}".format(reading))
    if model == "bert_base":
        layers = bert_data()[0].num_layers
        if any(n != layers * steps for n in launches.values()):
            problems.append("launches {} != {} layers x {} steps".format(launches, layers,
                                                                         steps))
    emit(name, **line)
    if problems:
        raise AssertionError("{}: {}".format(name, "; ".join(problems)))
    losses = {"{:.12g}".format(t["params"]["lr"]): -t["final_metric"] for t in trials}
    return line, launches, losses


def phase_slice_warm(exp_root):
    """bench.py's warm_start A/B on the card, arm by arm in one call: the
    MNIST headline at bench's own values, then BERT-base at full width. The
    warm arms must show AB_TRIALS - 1 hits and 1 miss and run from graphs,
    the cold arms no hit and no graph, and each warm trial's final loss
    must agree with the cold trial's of the same lr within AB_LOSS_TOL.
    Returns the BERT-base warm arm's launches and final losses by lr."""
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    arms = {
        "mnist": (functools.partial(train_mnist, batch=AB_MNIST_BATCH, budget=AB_MNIST_BUDGET),
                  {"lr": ("DOUBLE_LOG", [1e-4, 3e-2])}),
        "bert_base": (train_bert_ab, {"lr": ("DOUBLE_LOG", [1e-5, 1e-4])}),
    }
    out, bert_launches, bert_losses = {}, None, None
    for model, (train, space) in arms.items():
        lines, losses = {}, {}
        for arm, warm_on in (("warm", True), ("cold", False)):
            lines[arm], launches, losses[arm] = compile_ab_arm(model, arm, warm_on, exp_root,
                                                               train, space)
            if model == "bert_base" and warm_on:
                bert_launches, bert_losses = launches, losses[arm]
                CAPTURED["bert_base_warm"] = lines[arm]["warm"]["captured"]
        rel, absolute = AB_LOSS_TOL[model]
        diffs = {lr: abs(losses["warm"][lr] - cold) for lr, cold in losses["cold"].items()
                 if lr in losses["warm"]}
        bad = {lr: d for lr, d in diffs.items() if not d <= rel * abs(losses["cold"][lr]) + absolute}
        out[model] = {"wall_s": {arm: lines[arm]["wall_s"] for arm in lines},
                      "wall_ratio_cold_over_warm": lines["cold"]["wall_s"] / lines["warm"]["wall_s"],
                      "ttfm_gate_warm_arm": lines["warm"]["gate"],
                      "step_ms_in_sweep_median": {arm: lines[arm]["step_ms_in_sweep_median"]
                                                  for arm in lines},
                      "final_loss_max_abs_diff": max(diffs.values()) if diffs else None,
                      "loss_tol": {"relative": rel, "absolute": absolute}}
        if len(diffs) != AB_TRIALS or bad:
            emit("slice_warm", **out)
            raise AssertionError("slice_warm/{}: warm losses off the cold arm's: {} of {} "
                                 "compared, {}".format(model, len(diffs), AB_TRIALS, bad))
    emit("slice_warm", phase_s=time.perf_counter() - t_phase, **out)
    return bert_launches, bert_losses


# --------------------------------------------------------------- slice_lanes


def lanes_trainer(model, factory, lanes, warm_start=None):
    """A VmapTrainer over a block's lanes: each lane's ``lr`` its
    learning rate, every lane from the seed-0 init."""
    from maggy_tpu_torch.train.vmap import VmapTrainer

    return VmapTrainer(model, factory, [{"learning_rate": h["lr"]} for h in lanes.hparams],
                       labels_loss, device=DEVICE, warm_start=warm_start).init(seed=0)


def train_lanes(vt, batch, steps, every, reporter, lanes, record):
    """A block's lanes through ``steps`` lockstep steps, their [K] losses
    broadcast every ``every`` steps and lanes the driver stopped masked and
    retired; returns each lane's final metric (-loss) by trial id."""
    with record:
        for i in range(steps):
            losses = vt.step(batch(i))
            record.steps += 1
            if i % every == every - 1 or every == 1:
                reporter.broadcast_lanes(-losses, step=i)
                stopped = lanes.take_stopped()
                if stopped:
                    values = (-losses).tolist()
                    for lane in stopped:
                        vt.mask_lane(lane)
                        lanes.retire(lane, values[lane])
    final = (-losses).tolist()
    return {tid: final[i] for i, tid in enumerate(lanes.trial_ids)}


def mnist_mlp(device):
    from maggy_tpu_torch.models import MnistMLP

    return MnistMLP(features=8, num_classes=2, image_size=16, device=device)


def mnist_vmap_batch(n=LANES_BATCH):
    """bench.py's --vmap batch: the first ``n`` of make_data(seed 0), on the
    card."""
    def build():
        X, Y = make_data()
        return {"inputs": (torch.as_tensor(X[:n], device=DEVICE),),
                "labels": torch.as_tensor(Y[:n], device=DEVICE).long()}

    return cached(("mnist_vmap", n), build)


def train_mnist_vmap(lr, reporter, out_dir, lanes=None):
    """bench.py's train_mnist_vmap (``bench.py:115-164``) on the card: the
    MnistMLP trained full batch for LANES_STEPS steps under
    ``swept_transform(adam, learning_rate=lr)``, a heartbeat every
    LANES_REPORT_EVERY steps; a block's lanes as one VmapTrainer."""
    from maggy_tpu_torch.train import Trainer, adam, swept_transform

    record = TrialRecord(out_dir, reporter)
    full_fp32()
    batch = mnist_vmap_batch()
    steps = LANES_STEPS[0]
    if lanes is not None:
        return train_lanes(lanes_trainer(mnist_mlp("meta"), adam, lanes), lambda i: batch,
                           steps, LANES_REPORT_EVERY, reporter, lanes, record)
    trainer = Trainer(mnist_mlp("meta"), swept_transform(adam, learning_rate=lr), labels_loss,
                      device=DEVICE).init(seed=0)
    with record:
        for i in range(steps):
            loss = trainer.step(batch)
            record.steps += 1
            if i % LANES_REPORT_EVERY == 0:
                reporter.broadcast(-loss, step=i)
    return {"metric": -float(loss)}


def lanes_cut():
    """bench's 2500 steps a trial, cut so that an arm of LANES_TRIALS trials
    takes about LANES_ARM_BUDGET_S: one scalar trial's replayed step time
    (after its eager and capture steps) times the steps, plus the trial's
    set-up, fits LANES_ARM_BUDGET_S / LANES_TRIALS; a multiple of the
    heartbeat cadence. Returns (steps, the timing)."""
    from maggy_tpu_torch.train import Trainer, adam, clear_warm, swept_transform

    clear_warm()
    batch, n = mnist_vmap_batch(), 400
    t0 = time.perf_counter()
    trainer = Trainer(mnist_mlp("meta"), swept_transform(adam, learning_rate=1e-2), labels_loss,
                      device=DEVICE).init(seed=0)
    for _ in range(3):
        trainer.step(batch)
    stream_sync()
    setup_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    for _ in range(n):
        trainer.step(batch)
    stream_sync()
    step_ms = (time.perf_counter() - t1) * 1e3 / n
    clear_warm()
    per_trial_s = LANES_ARM_BUDGET_S / LANES_TRIALS
    fit = int((per_trial_s * 1e3) / step_ms) // LANES_REPORT_EVERY * LANES_REPORT_EVERY
    steps = max(LANES_REPORT_EVERY, min(LANES_BENCH_STEPS, fit))
    return steps, {"scalar_step_ms": step_ms, "first_trial_setup_s": setup_s,
                   "bench_steps": LANES_BENCH_STEPS, "steps": steps,
                   "arm_budget_s": LANES_ARM_BUDGET_S,
                   "trial_s_estimate": steps * step_ms / 1e3}


def lanes_ab_arm(arm, k, exp_root):
    """One arm of bench.py's vmap_main (``bench.py:1315-1440``) on the card:
    (line, finalized trial ids, journal events)."""
    from maggy_tpu_torch import OptimizationConfig, Searchspace, experiment
    from maggy_tpu_torch.train import clear_warm, warm

    name = "slice_lanes/mnist/{}".format(arm)
    exp_dir = fresh_dir(os.path.join(exp_root, "mnist", arm))
    out_dir = fresh_dir(os.path.join(exp_dir, "records"))
    clear_warm()
    config = OptimizationConfig(
        name="bench_vmap_{}".format(arm), num_trials=LANES_TRIALS, optimizer="randomsearch",
        searchspace=Searchspace(lr=("DOUBLE_LOG", [1e-3, 3e-2])), direction="max",
        num_workers=1, hb_interval=0.05, es_policy="none", seed=LANES_SEED,
        experiment_dir=os.path.join(exp_dir, "exp"), **({"vmap_lanes": k} if k else {}))
    before = warm.counters()
    t0 = time.perf_counter()
    result = experiment.lagom(functools.partial(train_mnist_vmap, out_dir=out_dir), config)
    wall = time.perf_counter() - t0
    telemetry = journal_check(name, os.path.join(exp_dir, "exp"), result)
    reading = warm_reading(name, telemetry, before)
    clear_warm()
    events = telemetry["_events"]
    records = read_records(out_dir)
    trial_events = [e for e in events if e["ev"] == "trial"]
    finals = [e["trial"] for e in trial_events if e["phase"] == "finalized"]
    lane_assigned = [e for e in trial_events if e["phase"] == "assigned"
                     and e.get("lane") is not None]
    line = {"wall_s": wall, "trials": len(finals), "dispatches": len(records),
            "steps": sum(r["steps"] for r in records),
            "step_ms_in_sweep_median": float(np.median([r["step_ms"] for r in records])),
            "lane_assignments": len(lane_assigned),
            "blocks": len({e["block"] for e in lane_assigned}),
            "lane_tagged_edges": sum(1 for e in trial_events if e.get("lane") is not None),
            "goodput_s": telemetry["goodput"]["buckets_s"],
            "goodput_shares": telemetry["goodput"]["shares"],
            "lane_idle_s": telemetry["_goodput"]["buckets"].get("lane_idle", 0.0),
            "warm": reading}
    emit(name, **line)
    if not (len(finals) == len(set(finals)) == result["num_trials"] == LANES_TRIALS):
        raise AssertionError("{}: {} finalized edges, {} trials, of {}".format(
            name, len(finals), len(set(finals)), LANES_TRIALS))
    return line, finals


def lanes_engine_gates():
    """bench.py's _vmap_lane_parity (``bench.py:1264-1313``) on the card,
    TF32 off: 4 rates, 25 steps on make_data's first 128, each gate beside
    its limit."""
    from maggy_tpu_torch.train import Trainer, adam, clear_warm, swept_transform
    from maggy_tpu_torch.train.vmap import VmapTrainer

    full_fp32()
    batch = mnist_vmap_batch(128)
    lrs, steps, (rel, absolute) = LANES_PARITY_LRS, LANES_PARITY_STEPS, LANES_TOL

    def scalar_run(lr):
        trainer = Trainer(mnist_mlp("meta"), swept_transform(adam, learning_rate=lr),
                          labels_loss, device=DEVICE).init(seed=0)
        return torch.stack([trainer.step(batch) for _ in range(steps)]).cpu().numpy()

    def block(rates, fresh=True):
        if fresh:
            clear_warm()
        return VmapTrainer(mnist_mlp("meta"), adam, [{"learning_rate": r} for r in rates],
                           labels_loss, device=DEVICE).init(seed=0)

    def run(vt, n=steps, mask_at=None):
        out = []
        for t in range(n):
            if t == mask_at:
                vt.mask_lane(1)
            out.append(vt.step(batch))
        return torch.stack(out).cpu().numpy()

    def off(a, b):
        """(max |a - b|, max of |a - b| - (rel |b| + abs): <= 0 passes)."""
        d = np.abs(a - b)
        return float(d.max()), float((d - (rel * np.abs(b) + absolute)).max())

    clear_warm()
    scalar = {lr: scalar_run(lr) for lr in lrs}
    fresh_vt = block(lrs)
    fresh = run(fresh_vt)
    lane_vs_scalar = [off(fresh[:, i], scalar[lr]) for i, lr in enumerate(lrs)]
    masked = run(block(lrs), mask_at=LANES_MASK_AT)
    survivors_bitwise = all(np.array_equal(masked[:, i], fresh[:, i]) for i in (0, 2, 3))
    refill_vt = block(lrs)
    run(refill_vt, mask_at=LANES_MASK_AT)
    refill_vt.refill_lane(1, {"learning_rate": 5e-3})
    refilled = run(refill_vt)[:, 1]
    clear_warm()
    refill_off = off(refilled, scalar_run(5e-3))
    first = block([2e-3, 4e-3, 6e-3, 8e-3])
    run(first, n=2)
    unit = first._unit
    first.retire_to_warm_cache()
    second = block(lrs, fresh=False)
    reused = second._unit is unit
    second_losses = run(second)
    reinit_off = off(second_losses, fresh)
    clear_warm()
    gates = {"tolerance": {"relative": rel, "absolute": absolute},
             "lane_vs_scalar_max_abs": [d for d, _ in lane_vs_scalar],
             "lane_vs_scalar_ok": all(x <= 0 for _, x in lane_vs_scalar),
             "masked_at_step": LANES_MASK_AT, "survivors_bitwise": survivors_bitwise,
             "refill_vs_scalar_cold_max_abs": refill_off[0], "refill_ok": refill_off[1] <= 0,
             "reinit_took_retired_unit": reused,
             "reinit_vs_fresh_max_abs": reinit_off[0], "reinit_ok": reinit_off[1] <= 0,
             "reinit_bitwise": bool(np.array_equal(second_losses, fresh))}
    bad = [k for k in ("lane_vs_scalar_ok", "survivors_bitwise", "refill_ok",
                       "reinit_took_retired_unit", "reinit_ok") if not gates[k]]
    return gates, bad


def lanes_kernel_check():
    """The flash kernels' batching rule at BERT-base width (bf16, B=32,
    S=128, 12 heads, key padding broadcast across BERT_LANES lanes): vmap of
    flash_attention and of its gradient against each lane alone through the
    kernels, and the launches of the vmapped calls (one each)."""
    from maggy_tpu_torch.ops import attention as A

    K = BERT_LANES
    q, k, v, do, mask = make_inputs(K * BERT_B, BERT_S, BERT_S, 12, 12, 64, torch.bfloat16,
                                    True, seed=3)
    q, k, v, do = (x.reshape(K, BERT_B, *x.shape[1:]) for x in (q, k, v, do))
    mask = mask[:BERT_B].contiguous()

    def attend(q_, k_, v_):
        return A.flash_attention(q_, k_, v_, mask, False)

    def objective(q_, k_, v_, do_):
        return (attend(q_, k_, v_).float() * do_.float()).sum()

    A.reset_launch_counts()
    out = torch.func.vmap(attend)(q, k, v)
    grads = torch.func.vmap(torch.func.grad(objective, argnums=(0, 1, 2)))(q, k, v, do)
    torch.cuda.synchronize()
    launches = A.launch_counts()
    err, tol = 0.0, float("inf")
    for i in range(K):
        leaves = [x[i].detach().clone().requires_grad_() for x in (q, k, v)]
        ref = attend(*leaves)
        ref.backward(do[i])
        for got, want in [(out[i], ref.detach())] + [(g[i], leaf.grad)
                                                     for g, leaf in zip(grads, leaves)]:
            err = max(err, float((got.float() - want.float()).abs().max()))
            tol = min(tol, tolerance(torch.bfloat16, want))
    A.reset_launch_counts()
    return {"lanes": K, "shape": [BERT_B, BERT_S, 12, 64], "max_abs_err": err, "tol": tol,
            "launches": launches,
            "ok": err <= tol and launches == {"flash_fwd": 2, "flash_bwd_dkdv": 1,
                                              "flash_bwd_dq": 1}}


def op_device_ms(step, steps=3, top=10):
    """The ``top`` PyTorch operators by their own device time per step
    over ``steps`` eager steps (a replayed graph's kernels belong to no
    operator, so the attribution needs eager steps)."""
    from torch.autograd import DeviceType

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for i in range(steps):
            step(i)
        torch.cuda.synchronize()
    ops = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CPU and e.self_device_time_total > 0]
    ops.sort(key=lambda e: -e.self_device_time_total)
    return [[e.key, e.self_device_time_total / 1e3 / steps, e.count / steps] for e in ops[:top]]


def lanes_step_alone(make, batch, warmup=3, n=10):
    """Host-clock ms of one trainer's replayed step alone on the card."""
    trainer = make()
    for i in range(warmup):
        trainer.step(batch(i))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n):
        trainer.step(batch(i))
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n, trainer


def lanes_resnet_arm():
    """resnet50_lanes: RESNET_LANES_K lanes of slice_resnet's ResNet-50
    (width 64, batch 128, fp32, TF32 off) with has_aux_collections and
    train=True, one captured VmapTrainer step a batch for
    RESNET_LANES_STEPS batches of the example's iterator; then each lane's
    own scalar Trainer (same seed, rate and weight decay) on the same
    batches. Returns (line, problems)."""
    from maggy_tpu_torch.models import ResNet
    from maggy_tpu_torch.train import adamw, clear_warm, warm
    from maggy_tpu_torch.train.vmap import VmapTrainer

    full_fp32()
    clear_warm()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    it = resnet_batches()
    batches = [next(it) for _ in range(RESNET_LANES_STEPS)]
    before = warm.counters()
    t0 = time.perf_counter()
    vt = VmapTrainer(ResNet(depth=RESNET_DEPTH, num_classes=2, width=64, device="meta"), adamw,
                     [{"learning_rate": lr} for lr in RESNET_LANES_LRS], labels_loss,
                     device=DEVICE, has_aux_collections=True, train_kwargs={"train": True},
                     weight_decay=RESNET_LANES_WD).init(seed=0)
    losses = torch.stack([vt.step(b) for b in batches]).cpu().numpy()
    lanes_s = time.perf_counter() - t0
    reading = {k: warm.counters()[k] - before[k] for k in warm.COUNTER_KEYS}
    state = {i: {k: v.detach().cpu() for k, v in vt.lane_state_dict(i).items()}
             for i in range(len(RESNET_LANES_LRS))}
    untouched = all(torch.equal(b.cpu(), torch.zeros_like(b.cpu()) if n.endswith(".mean")
                                else torch.ones_like(b.cpu()))
                    for n, b in vt.model.named_buffers())
    peak_lanes = torch.cuda.max_memory_allocated() / 1e9
    del vt
    clear_warm()
    gc.collect()
    torch.cuda.empty_cache()
    per_lane = []
    for i, lr in enumerate(RESNET_LANES_LRS):
        scalar = resnet_trainer(lr, 64, RESNET_LANES_WD)
        ref = np.asarray([float(scalar.step(b)) for b in batches])
        want = {k: v.detach().cpu() for k, v in scalar.model.state_dict().items()}

        def off(names):
            return max(float((state[i][k] - want[k]).abs().max())
                       / (1.0 + float(want[k].abs().max())) for k in names)

        stat_names = [k for k in want if k.endswith((".mean", ".var"))]
        per_lane.append({"lr": lr,
                         "loss_rel_err": float(np.max(np.abs(losses[:, i] - ref) / np.abs(ref))),
                         "stats_err": off(stat_names),
                         "params_err": off([k for k in want if k not in stat_names]),
                         "tol_stats_params": RESNET_LANES_TOL_PER_LR * lr})
        del scalar
        clear_warm()
    # The witness: the largest rate's scalar Trainer run again, against its
    # first run (cuDNN may pick other algorithms run to run).
    scalar = resnet_trainer(RESNET_LANES_LRS[-1], 64, RESNET_LANES_WD)
    ref2 = np.asarray([float(scalar.step(b)) for b in batches])
    again = {k: v.detach().cpu() for k, v in scalar.model.state_dict().items()}
    witness = {"lr": RESNET_LANES_LRS[-1],
               "loss_rel_err": float(np.max(np.abs(ref2 - ref) / np.abs(ref))),
               "stats_params_err": max(float((again[k] - want[k]).abs().max())
                                       / (1.0 + float(want[k].abs().max())) for k in want)}
    del scalar
    clear_warm()
    replayed = reading["graph_replays"] == RESNET_LANES_STEPS - 1 and reading["graph_failures"] == 0
    line = {"lanes": len(RESNET_LANES_LRS), "width": 64, "batch": RESNET_BATCH,
            "steps": RESNET_LANES_STEPS, "losses": losses.tolist(), "vs_scalar": per_lane,
            "witness_scalar_vs_scalar": witness,
            "loss_tol": RESNET_LANES_LOSS_TOL, "tol_per_lr": RESNET_LANES_TOL_PER_LR,
            "module_buffers_untouched": untouched, "warm": reading, "captured": replayed,
            "lanes_s": lanes_s, "peak_mem_lanes_gb": peak_lanes}
    problems = []
    far = [r for r in per_lane if not (r["loss_rel_err"] <= RESNET_LANES_LOSS_TOL
                                       and r["stats_err"] <= r["tol_stats_params"]
                                       and r["params_err"] <= r["tol_stats_params"])]
    if far:
        problems.append("resnet50 lanes off their scalar Trainers: {}".format(far))
    if not (untouched and replayed and np.isfinite(losses).all()):
        problems.append("resnet50 lanes: module buffers untouched {}, replayed {}: {}".format(
            untouched, replayed, reading))
    return line, problems


def moe_lanes_config():
    from maggy_tpu_torch.models import LlamaConfig

    return dataclasses.replace(
        LlamaConfig.llama3_8b(lora_rank=0), num_layers=MOE_LANES_LAYERS,
        num_experts=MOE_EXPERTS, moe_top_k=MOE_TOP_K, moe_capacity_factor=MOE_CAPACITY_FACTOR,
        param_dtype=torch.bfloat16, remat=False)


def lanes_moe_arm():
    """moe_lanes: MOE_LANES_K lanes of the MoE Llama (moe_lanes_config),
    MOE_LANES_STEPS eager VmapTrainer steps on seeded MOE_LANES_B x 2048
    token batches, each lane's objective (task loss plus the layers' load-
    balancing losses) against its own scalar Trainer's. Memory: a lane holds
    2.50 B parameters (embedding and head 2 x 525 M, a layer's 8 experts
    1.41 B and attention 42 M), at 2 bytes each as parameter, gradient
    buffer and AdamW's two moments (20 GB a lane), beside the unit's module
    (5 GB) and a step's own gradients (5 GB a lane); the dense logits'
    path (this arm's loss; the chunked loss also takes lanes, as
    slice_lora_lanes runs it) holds about 10 GB a lane at batch 2 x 2048. At batch 2 this arm ran out of
    memory on an H100 80GB after the ResNet arm; so batch 1 x 2048, about
    18 GB less. Returns (line, problems, launches)."""
    from maggy_tpu_torch.models import Llama
    from maggy_tpu_torch.ops import attention as A
    from maggy_tpu_torch.ops import next_token_loss
    from maggy_tpu_torch.train import Trainer, adamw, clear_warm, swept_transform
    from maggy_tpu_torch.train.vmap import VmapTrainer

    clear_warm()
    gc.collect()
    torch.cuda.empty_cache()
    # Earlier captures' cuBLAS workspaces (ROADMAP F13): the two lanes peak
    # within a few GB of the card's memory.
    torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.reset_peak_memory_stats()
    cfg = moe_lanes_config()
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(MOE_LANES_STEPS, MOE_LANES_B, LLAMA_S)), device=DEVICE)
    batches = [{"inputs": (t,), "tokens": t} for t in tokens]

    def loss_fn(logits, b):
        return next_token_loss(logits, b["tokens"])

    t0 = time.perf_counter()
    vt = VmapTrainer(Llama(cfg, device="meta"), adamw,
                     [{"learning_rate": lr} for lr in MOE_LANES_LRS], loss_fn, device=DEVICE,
                     warm_start=False).init(seed=0)
    init_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    A.reset_launch_counts()
    losses, aux = [], []
    t0 = time.perf_counter()
    for b in batches:
        losses.append(vt.step(b))
        aux.append(vt.aux_loss)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / MOE_LANES_STEPS
    launches = A.launch_counts()
    losses, aux = torch.stack(losses).float().cpu().numpy(), torch.stack(aux).float().cpu().numpy()
    peak_lanes = torch.cuda.max_memory_allocated() / 1e9
    del vt
    gc.collect()
    torch.cuda.empty_cache()
    rel, absolute = AB_LOSS_TOL["bert_base"]
    off, aux_off = 0.0, 0.0
    for i, lr in enumerate(MOE_LANES_LRS):
        scalar = Trainer(Llama(cfg, device="meta"), swept_transform(adamw, learning_rate=lr),
                         loss_fn, device=DEVICE, warm_start=False).init(seed=0)
        for t, b in enumerate(batches):
            ref = float(scalar.step(b))
            off = max(off, float(abs(losses[t, i] - ref) - (rel * abs(ref) + absolute)))
            aux_off = max(aux_off, float(abs(aux[t, i] - float(scalar.aux_loss))))
        del scalar
        gc.collect()
        torch.cuda.empty_cache()
    A.reset_launch_counts()
    expected = MOE_LANES_LAYERS * MOE_LANES_STEPS
    line = {"lanes": MOE_LANES_K, "layers": cfg.num_layers, "experts": cfg.num_experts,
            "param_dtype": str(cfg.param_dtype), "steps": MOE_LANES_STEPS,
            "batch": [MOE_LANES_B, LLAMA_S],
            "lrs": MOE_LANES_LRS, "losses": losses.tolist(), "aux_losses": aux.tolist(),
            "loss_excess_over_tol": off, "aux_max_abs_diff_vs_scalar": aux_off,
            "tol": {"relative": rel, "absolute": absolute}, "launches": launches,
            "expected_launches": expected, "init_s": init_s, "step_ms_eager": step_ms,
            "peak_mem_lanes_gb": peak_lanes, "captured": False}
    problems = []
    if off > 0 or not (np.isfinite(losses).all() and (aux > 0).all()):
        problems.append("MoE lanes off their scalar Trainers by {} over the tolerance, aux "
                        "{}".format(off, aux.tolist()))
    if any(launches.get(k) != expected for k in REPLACES):
        problems.append("MoE lanes launched {}, want {} each".format(launches, expected))
    return line, problems, launches


def phase_slice_lanes(exp_root, warm_bert_losses):
    """The vectorized lanes on the card (see the module docstring, phase
    17). Returns the BERT-base lanes sweep's launches."""
    from maggy_tpu_torch.models import BertEncoder
    from maggy_tpu_torch.ops import attention as A
    from maggy_tpu_torch.train import Trainer, adam, adamw, clear_warm, swept_transform

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    full_fp32()
    problems = []

    # (a) bench.py's --vmap A/B.
    LANES_STEPS[0], cut = lanes_cut()
    arms, finals = {}, {}
    for arm, k in (("scalar", None), ("lanes1", 1), ("vmap", LANES_K)):
        arms[arm], finals[arm] = lanes_ab_arm(arm, k, exp_root)
    if set(finals["lanes1"]) != set(finals["scalar"]):
        problems.append("lanes1 finalized {} where scalar finalized {}".format(
            sorted(set(finals["lanes1"]) ^ set(finals["scalar"])), "the others"))
    if arms["lanes1"]["lane_tagged_edges"] or arms["scalar"]["lane_tagged_edges"]:
        problems.append("lane-tagged edges without blocks: scalar {}, lanes1 {}".format(
            arms["scalar"]["lane_tagged_edges"], arms["lanes1"]["lane_tagged_edges"]))
    if arms["vmap"]["lane_assignments"] < LANES_TRIALS - LANES_K:
        problems.append("the vmap arm rode {} lane-tagged assignments of {} (need >= {})".format(
            arms["vmap"]["lane_assignments"], LANES_TRIALS, LANES_TRIALS - LANES_K))
    # A replayed step of each program, profiled: the card's idle share.
    batch = mnist_vmap_batch()
    clear_warm()
    scalar_trainer = Trainer(mnist_mlp("meta"), swept_transform(adam, learning_rate=1e-2),
                             labels_loss, device=DEVICE).init(seed=0)
    from maggy_tpu_torch.train.vmap import VmapTrainer

    block = VmapTrainer(mnist_mlp("meta"), adam,
                        [{"learning_rate": lr} for lr in np.geomspace(1e-3, 3e-2, LANES_K)],
                        labels_loss, device=DEVICE).init(seed=0)
    for _ in range(3):
        scalar_trainer.step(batch)
        block.step(batch)
    profiles = {"scalar": step_device_profile(lambda i: scalar_trainer.step(batch), steps=20),
                "vmap": step_device_profile(lambda i: block.step(batch), steps=20)}
    del scalar_trainer, block
    clear_warm()
    eager = VmapTrainer(mnist_mlp("meta"), adam,
                        [{"learning_rate": lr} for lr in np.geomspace(1e-3, 3e-2, LANES_K)],
                        labels_loss, device=DEVICE, warm_start=False).init(seed=0)
    eager.step(batch)
    vmap_ops = op_device_ms(lambda i: eager.step(batch), steps=5)
    del eager
    mnist = {"cut": cut, **{arm: arms[arm] for arm in arms},
             "speedup": arms["scalar"]["wall_s"] / arms["vmap"]["wall_s"],
             "speedup_bench_gate": float(os.environ.get("BENCH_VMAP_SPEEDUP", "5")),
             "step_profile": {arm: {key: p[key] for key in ("step_ms", "device_busy_ms",
                                                              "idle_share")}
                              for arm, p in profiles.items()},
             "vmap_eager_op_device_ms": vmap_ops}
    emit("slice_lanes/mnist", **mnist)

    # (b) The engine gates; (c) the kernels' batching rule at BERT width.
    gates, bad = lanes_engine_gates()
    problems += ["engine gate {} failed".format(k) for k in bad]
    kernel_rule = lanes_kernel_check()
    if not kernel_rule["ok"]:
        problems.append("vmapped flash kernels: {}".format(kernel_rule))
    emit("slice_lanes/engine", gates=gates, kernel_rule=kernel_rule)

    # (d) slice_warm's BERT-base sweep with vmap_lanes.
    clear_warm()
    A.reset_launch_counts()
    line, launches, losses = compile_ab_arm(
        "bert_base", "lanes", True, exp_root, train_bert_ab,
        {"lr": ("DOUBLE_LOG", [1e-5, 1e-4])}, lanes=BERT_LANES)
    CAPTURED["bert_base_lanes"] = line["warm"]["captured"]
    clear_warm()
    rel, absolute = AB_LOSS_TOL["bert_base"]
    diffs = {lr: abs(loss - warm_bert_losses[lr]) for lr, loss in losses.items()
             if lr in warm_bert_losses}
    far = {lr: d for lr, d in diffs.items() if not d <= rel * abs(warm_bert_losses[lr]) + absolute}
    if len(diffs) != AB_TRIALS or far:
        problems.append("BERT lanes' losses off slice_warm's: {} of {} compared, {}".format(
            len(diffs), AB_TRIALS, far))
    cfg, bert_batch = bert_data()
    lane_rates = [{"learning_rate": lr} for lr in np.geomspace(1e-5, 1e-4, BERT_LANES)]

    def scalar_bert(warm_start=None):
        return Trainer(BertEncoder(cfg, device="meta"), swept_transform(adamw, learning_rate=3e-5),
                       labels_loss, device=DEVICE, warm_start=warm_start).init(seed=0)

    def lanes_bert(warm_start=None):
        return VmapTrainer(BertEncoder(cfg, device="meta"), adamw, lane_rates, labels_loss,
                           device=DEVICE, warm_start=warm_start).init(seed=0)

    profiles, ops = {}, {}
    for label, make in (("scalar", scalar_bert), ("lanes", lanes_bert)):
        ms, trainer = lanes_step_alone(make, bert_batch, n=BERT_LANES_ALONE_STEPS)
        profiles[label] = dict(step_device_profile(lambda i: trainer.step(bert_batch(i)),
                                                   steps=BERT_LANES_PROFILE_STEPS),
                               replayed_step_alone_ms=ms)
        del trainer
        eager = make(warm_start=False)
        eager.step(bert_batch(0))
        ops[label] = op_device_ms(lambda i: eager.step(bert_batch(i)), steps=BERT_LANES_OP_STEPS)
        del eager
        clear_warm()
    scalar_ms = profiles["scalar"]["replayed_step_alone_ms"]
    lanes_ms = profiles["lanes"]["replayed_step_alone_ms"]
    bert = {"lanes": BERT_LANES, **line,
            "final_loss_max_abs_diff_vs_slice_warm": max(diffs.values()) if diffs else None,
            "loss_tol": {"relative": rel, "absolute": absolute},
            "replayed_step_alone_ms": {"lanes": lanes_ms, "scalar": scalar_ms,
                                       "scalar_x_lanes": scalar_ms * BERT_LANES},
            "step_profile": profiles, "eager_op_device_ms": ops}
    emit("slice_lanes/bert_base", **bert)
    peak = torch.cuda.max_memory_allocated()

    # (e) and (f): lanes of models with buffers or sowed losses.
    resnet, bad = lanes_resnet_arm()
    problems += bad
    emit("slice_lanes/resnet50_lanes", **resnet)
    moe, bad, moe_launches = lanes_moe_arm()
    problems += bad
    CAPTURED["llama3_8b_moe_lanes"] = False
    emit("slice_lanes/moe_lanes", **moe)
    emit("slice_lanes", phase_s=time.perf_counter() - t_phase,
         peak_mem_gb=max(peak, torch.cuda.max_memory_allocated()) / 1e9,
         speedup=mnist["speedup"], problems=problems)
    if problems:
        raise AssertionError("slice_lanes: {}".format("; ".join(problems)))
    return launches, moe_launches


def phase_slice_process(exp_dir, thread_step_ms):
    """The slice sweep on two runner processes: launches summed over the
    processes' trial records."""
    from maggy_tpu_torch.ops import attention as A

    gc.collect()
    torch.cuda.empty_cache()
    result, wall, records, driver_launches = bert_asha_sweep(exp_dir, "process")
    launches = {k: sum(r["launches"][k] for r in records) for k in A.launch_counts()}
    if any(driver_launches.values()):
        raise AssertionError("the driver process launched kernels in a process sweep: "
                             "{}".format(driver_launches))
    trials, promoted, total_steps, expected = check_bert_sweep(
        "slice_process", result, exp_dir, records, launches)
    telemetry = journal_check("slice_process", os.path.join(exp_dir, "exp"), result)
    reading_warm = warm_reading("slice_process", telemetry)
    CAPTURED["bert_base_process"] = reading_warm["captured"]
    pids = sorted({r["pid"] for r in records})
    if os.getpid() in pids:
        raise AssertionError("trials ran in the driver process {}, not only in runner "
                             "processes {}".format(os.getpid(), pids))
    step_ms = float(np.median([r["step_ms"] for r in records]))
    READINGS["slice_process_step_ms"] = step_ms
    emit("slice_process", trials_finished=len(trials), promoted=promoted,
         early_stopped=result["early_stopped"], best_val=result["best_val"],
         steps=total_steps, launches=launches, expected_launches_each=expected,
         sweep_wall_s=wall, step_ms_in_sweep_median=step_ms,
         thread_step_ms_in_sweep_median=thread_step_ms,
         runner_peak_mem_gb={str(pid): max(r["peak_mem_gb"] for r in records if r["pid"] == pid)
                             for pid in pids},
         time_split=time_split(records), runner_setup=runner_setup(telemetry),
         lost_runners=result["lost_runners"], pipeline=pipeline_summary(result["pipeline"]),
         warm=reading_warm, telemetry=public(telemetry))
    return launches


def percentiles(values):
    """p50 and max of a list of ms (None for an empty list)."""
    if not values:
        return None
    return {"n": len(values), "p50": float(np.median(values)), "max": float(max(values))}


def pipeline_summary(pipe):
    """The driver's hand-off counters of one sweep (result.json's
    "pipeline"), with latencies reduced to p50 and max."""
    return {"prefetch": pipe["prefetch"],
            "suggest_ms": {src: percentiles(v) for src, v in pipe["suggest_ms"].items()},
            "suggest_threads": pipe["suggest_threads"],
            "handoff_ms": {pid: percentiles(v) for pid, v in sorted(pipe["handoff_ms"].items())},
            "prefetch_hits": pipe["prefetch_hits"], "prefetch_misses": pipe["prefetch_misses"],
            "invalidated": pipe["invalidated"], "lock_fallbacks": pipe["lock_fallbacks"]}


def phase_slice_bo(exp_root, asha_step_ms):
    """The BERT-base sweep of examples/bert_glue_hpo.py under TPE, then
    GP + Hyperband with prefetch on and off: same model, data and trainer
    as phase_slice."""
    from maggy_tpu_torch import OptimizationConfig, Searchspace, experiment
    from maggy_tpu_torch.models import BertConfig, BertEncoder
    from maggy_tpu_torch.ops import attention as A
    from maggy_tpu_torch.optimizers.bayes import GP, TPE
    from maggy_tpu_torch.train import (Trainer, adamw, clear_warm, cross_entropy_loss, warm,
                                       warmup_cosine_decay_schedule)

    t_phase = time.perf_counter()
    cfg = BertConfig.base()
    tokens, mask, labels = make_dataset(cfg.vocab_size, 16, seed=0)
    n_rows = tokens.shape[0]
    lock = threading.Lock()
    steps_taken, step_ms = [], {32: [], 64: []}

    def make_batch(i, size):
        lo = (i * size) % (n_rows - size + 1)
        return {"inputs": (tokens[lo:lo + size], mask[lo:lo + size]),
                "labels": labels[lo:lo + size]}

    def loss_fn(logits, b):
        return cross_entropy_loss(logits, b["labels"])

    def train_bert(lr, warmup_frac, batch, reporter, budget=None):
        size = int(batch)
        total = BO_TPE_STEPS if budget is None else int(budget) * BO_STEPS_PER_BUDGET
        sched = warmup_cosine_decay_schedule(0.0, lr, int(total * warmup_frac), total)
        trainer = Trainer(BertEncoder(cfg, device="meta"), adamw(sched), loss_fn,
                          device="cuda").init(seed=0)
        done = 0
        stream_sync()
        t0 = time.perf_counter()
        try:
            for i in range(total):
                loss = trainer.step(make_batch(i, size))
                done += 1
                if i % BO_REPORT_EVERY == BO_REPORT_EVERY - 1 or i == total - 1:
                    reporter.broadcast(-loss, step=i)
        finally:
            stream_sync()
            with lock:
                steps_taken.append(done)
                step_ms[size].append((time.perf_counter() - t0) * 1e3 / max(done, 1))
        final = float(loss)
        if not math.isfinite(final):
            raise FloatingPointError("non-finite loss {}".format(final))
        return {"metric": -final}

    def gp():
        return GP(acquisition="ei", async_strategy="impute", impute_strategy="cl_min",
                  num_warmup_trials=4, seed=0, pruner="hyperband",
                  pruner_kwargs=dict(min_budget=1, max_budget=9, eta=3, n_iterations=1))

    # The search space and settings of examples/bert_glue_hpo.py.
    sp = Searchspace(lr=("DOUBLE", [1e-5, 1e-3]), warmup_frac=("DOUBLE", [0.0, 0.3]),
                     batch=("DISCRETE", [32, 64]))
    sweeps = [("tpe", TPE(num_warmup_trials=4, seed=0), BO_TPE_TRIALS, True, BO_TPE_TRIALS),
              ("gp_hyperband", gp(), 1, True, 13),
              ("gp_hyperband_no_prefetch", gp(), 1, False, 13)]
    out, launches_all = {}, {}
    for name, optimizer, num_trials, prefetch, expected_trials in sweeps:
        exp_dir = fresh_dir(os.path.join(exp_root, name))
        config = OptimizationConfig(
            name="bert_base_" + name, num_trials=num_trials, optimizer=optimizer,
            searchspace=sp, direction="max", num_workers=2, es_policy="median", es_min=3,
            hb_interval=0.1, seed=0, experiment_dir=exp_dir, prefetch=prefetch)
        del steps_taken[:]
        for v in step_ms.values():
            del v[:]
        before = warm.counters()
        A.reset_launch_counts()
        t0 = time.perf_counter()
        result = experiment.lagom(train_bert, config)
        wall = time.perf_counter() - t0
        launches = A.launch_counts()
        trials = read_trials(exp_dir)
        pipe = result["pipeline"]
        telemetry = journal_check("slice_bo " + name, exp_dir, result)
        reading_warm = warm_reading("slice_bo " + name, telemetry, before)
        types = [t["info_dict"]["sample_type"] for t in trials]
        total_steps = sum(steps_taken)
        expected = cfg.num_layers * total_steps
        summary = {
            "trials_finished": len(trials), "expected_trials": expected_trials,
            "sample_types": {k: types.count(k) for k in sorted(set(types))},
            "budgets": sorted(t["params"].get("budget", 0) for t in trials),
            "early_stopped": result["early_stopped"], "best_hp": result["best_hp"],
            "best_val": result["best_val"], "steps": total_steps, "launches": launches,
            "expected_launches_each": expected, "sweep_wall_s": wall,
            "step_ms_median": float(np.median(step_ms[32] + step_ms[64])),
            "step_ms_median_by_batch": {b: float(np.median(v)) for b, v in step_ms.items() if v},
            **pipeline_summary(pipe), "warm": reading_warm, "telemetry": public(telemetry)}
        emit("slice_bo_sweep", sweep=name, controller=type(optimizer).__name__, **summary)
        problems = []
        if not (len(trials) == result["num_trials"] == expected_trials
                and all(t["status"] == "FINALIZED" for t in trials)
                and math.isfinite(result["best_val"])):
            problems.append("{} of {} trials finalized".format(len(trials), expected_trials))
        if "model" not in types:
            problems.append("no model-proposed trial")
        if "rpc-server" in pipe["suggest_threads"]:
            problems.append("suggest() ran on the RPC server's thread")
        if prefetch and name.startswith("gp") and pipe["prefetch_hits"] == 0:
            problems.append("no prefetch hit")
        if any(n != expected for n in launches.values()) or expected == 0:
            problems.append("launches {} != {} layers x {} steps".format(
                launches, cfg.num_layers, total_steps))
        if problems:
            raise AssertionError("slice_bo {}: {}".format(name, "; ".join(problems)))
        out[name] = summary
        for k, n in launches.items():
            launches_all[k] = launches_all.get(k, 0) + n

    clear_warm()
    CAPTURED["bert_base_bo"] = all(v["warm"]["captured"] for v in out.values())
    emit("slice_bo", sweeps=list(out), launches=launches_all,
         captured=CAPTURED["bert_base_bo"],
         step_ms_median={"asha": asha_step_ms,
                         **{name: v["step_ms_median"] for name, v in out.items()}},
         handoff_ms={name: v["handoff_ms"] for name, v in out.items()},
         suggest_ms={name: v["suggest_ms"] for name, v in out.items()},
         sweep_wall_s={name: v["sweep_wall_s"] for name, v in out.items()},
         best_val={name: v["best_val"] for name, v in out.items()},
         phase_s=time.perf_counter() - t_phase)
    return launches_all


def step_device_profile(step, steps=5):
    """Per training step over ``steps`` steps under torch.profiler: the
    host-clock step time, the device's busy time (every kernel and copy),
    the attention kernels' part and its split by kernel (ms per step,
    launches per step, ms per launch), the largest kernels, and the
    device's idle share of those same steps."""
    from torch.autograd import DeviceType

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(steps):
            step(i)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / steps
    # GPU-side user annotations (the optimizer's step range) span kernels
    # that are counted on their own.
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
              and not e.is_user_annotation]
    device = {e.key: e.self_device_time_total / 1e3 / steps for e in events}
    busy = sum(device.values())
    if busy == 0:
        raise AssertionError("the profiler recorded no device time over {} steps".format(steps))
    flash = {re.search(r"flash_\w+(<[^>]*>)?", e.key).group(0): {
        "ms_per_step": e.self_device_time_total / 1e3 / steps,
        "launches_per_step": e.count / steps,
        "ms_per_launch": e.self_device_time_total / 1e3 / e.count}
        for e in events if "flash_" in e.key}
    top = sorted(device.items(), key=lambda kv: -kv[1])[:8]
    return {"step_ms": step_ms, "device_busy_ms": busy,
            "attention_kernels_ms": sum(v for k, v in device.items() if "flash_" in k),
            "attention_kernels": flash, "idle_share": 1.0 - busy / step_ms,
            "top_kernels_ms": [[k[:90], v] for k, v in top]}


def read_trials(exp_dir):
    trials = []
    for run in os.listdir(exp_dir):
        for entry in os.listdir(os.path.join(exp_dir, run)):
            path = os.path.join(exp_dir, run, entry, "trial.json")
            if os.path.exists(path):
                with open(path) as f:
                    trials.append(json.load(f))
    return trials


def bf16_tolerance(ref):
    """Card (kernels, cuBLAS) against the CPU path (reference attention),
    both computing in bf16: 5e-2 of the largest CPU value, about a dozen
    bf16 roundings (2^-8 relative each) of the largest entry, for a layer
    or two whose residual stream, products and attention probabilities are
    rounded to bf16 at different places on the two sides."""
    return 5e-2 * float(ref.float().abs().max()) + 1e-6


def llama_lora_sweep(phase, name, exp_dir, make_trainer, batch, layers):
    """slice_llama's sweep: the search space of examples/llama_lora_sweep.py
    under ASHA(3, 1, 3) (3 rung-0 trials and 1 promotion) on two thread
    runners, LLAMA_STEPS_PER_BUDGET steps a budget unit, a heartbeat a step.
    ``make_trainer(lora_rank, lora_alpha, lr)`` returns a trial's trainer
    and a function of its step's loss whose value is kept per step (or
    None). Checks the trial and step counts and the kernels' launches (the
    forward twice per layer and step under remat), replays the journal, and
    returns what the phase line reads."""
    from maggy_tpu_torch import OptimizationConfig, Searchspace, experiment
    from maggy_tpu_torch.ops import attention as A
    from maggy_tpu_torch.optimizers import Asha
    from maggy_tpu_torch.train import clear_warm, warm

    lock = threading.Lock()
    steps_taken, step_ms, rows = [], [], []

    def train_llama(lora_rank, lora_alpha, lr, budget, reporter):
        trainer, on_step = make_trainer(lora_rank, lora_alpha, lr)
        total = int(budget) * LLAMA_STEPS_PER_BUDGET
        mine, done = [], 0
        stream_sync()
        t0 = time.perf_counter()
        try:
            for i in range(total):
                loss = trainer.step(batch(i))
                if on_step is not None:
                    mine.append(on_step(loss))
                done += 1
                reporter.broadcast(-loss, step=i)
        finally:
            stream_sync()
            with lock:
                steps_taken.append(done)
                step_ms.append((time.perf_counter() - t0) * 1e3 / max(done, 1))
                rows.extend([float(x) for x in row] for row in mine)
        final = float(loss)
        if not math.isfinite(final):
            raise FloatingPointError("non-finite loss {}".format(final))
        return {"metric": -final}

    sp = Searchspace(lora_rank=("DISCRETE", [4, 8, 16]), lora_alpha=("DOUBLE", [4.0, 32.0]),
                     lr=("DOUBLE", [1e-4, 3e-3]))
    config = OptimizationConfig(
        name=name, num_trials=3,
        optimizer=Asha(reduction_factor=3, resource_min=1, resource_max=3, seed=0),
        searchspace=sp, direction="max", num_workers=2, es_policy="none",
        hb_interval=0.1, seed=0, experiment_dir=exp_dir)
    before = warm.counters()
    A.reset_launch_counts()
    t0 = time.perf_counter()
    result = experiment.lagom(train_llama, config)
    wall = time.perf_counter() - t0
    launches = A.launch_counts()
    peak_sweep = torch.cuda.max_memory_allocated()
    clear_warm()

    trials = read_trials(exp_dir)
    promoted = sum(1 for t in trials if t["info_dict"].get("sample_type") == "promoted")
    finished = [t for t in trials if t["final_metric"] is not None
                and math.isfinite(t["final_metric"])]
    total_steps = sum(steps_taken)
    expected = {"flash_fwd": 2 * layers * total_steps, "flash_bwd_dkdv": layers * total_steps,
                "flash_bwd_dq": layers * total_steps}
    if not (len(trials) == len(finished) == result["num_trials"] == 4 and promoted == 1
            and total_steps == 12 and math.isfinite(result["best_val"])):
        raise AssertionError("{} sweep malformed: {} trials ({} finished, {} promoted), "
                             "{} steps, {}".format(phase, len(trials), len(finished), promoted,
                                                   total_steps, result))
    if launches != expected:
        raise AssertionError("{} launches {} != {} (remat: the forward twice per layer and "
                             "step)".format(phase, launches, expected))
    telemetry = journal_check(phase, exp_dir, result)
    return {"result": result, "wall": wall, "launches": launches, "expected": expected,
            "trials_finished": len(finished), "promoted": promoted, "steps": total_steps,
            "step_ms": step_ms, "rows": rows, "telemetry": telemetry, "before": before,
            "peak_sweep": peak_sweep}


def llama_tokens(vocab_size):
    """Four token batches of LLAMA_B x LLAMA_S over the whole vocabulary,
    made from a numpy seed, on the card."""
    return torch.as_tensor(np.random.default_rng(0).integers(
        0, vocab_size, size=(4, LLAMA_B, LLAMA_S)), device="cuda")


def llama_full_width(phase, cfg2, tokens):
    """A model of ``cfg2``'s depth (1 layer) at full width on the card
    (kernels) against the same weights on the CPU (reference attention):
    hidden states, the chunked loss and the layer-0 adapters' gradients,
    with the base frozen in bf16 as in the sweep and lora_b drawn nonzero so
    every adapter has one. Raises on a miss; returns the errors beside their
    tolerances."""
    from maggy_tpu_torch.models import Llama
    from maggy_tpu_torch.ops import chunked_next_token_loss
    from maggy_tpu_torch.train import adamw, only_lora

    gen = torch.Generator(device="cuda").manual_seed(3)
    model = Llama(cfg2, device="cuda")
    model.init_weights(gen)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("lora_b"):
                p.normal_(0.0, 0.02, generator=gen)
    only_lora(adamw(1e-4))(model)
    cpu_model = copy.deepcopy(model).to("cpu")
    small = tokens[0, :1, :128]

    def forward_backward(m, toks):
        hidden, head = m(toks, return_hidden=True)
        loss = chunked_next_token_loss(hidden, head, toks)
        loss.backward()
        grads = {n: p.grad.float().cpu() for n, p in m.named_parameters()
                 if n.startswith("layers.0.") and p.grad is not None}
        return hidden.detach().float().cpu(), loss.item(), grads

    t_cpu = time.perf_counter()
    c_hidden, c_loss, c_grads = forward_backward(cpu_model, small.cpu())
    cpu_s = time.perf_counter() - t_cpu
    g_hidden, g_loss, g_grads = forward_backward(model, small)
    del model, cpu_model
    full_width = {"hidden_max_abs_err": float((g_hidden - c_hidden).abs().max()),
                  "hidden_tol": bf16_tolerance(c_hidden), "loss": g_loss, "cpu_loss": c_loss,
                  "loss_tol": 1e-2 * abs(c_loss), "cpu_seconds": cpu_s,
                  "adapter_grads": {n: [float((g_grads[n] - c_grads[n]).abs().max()),
                                        bf16_tolerance(c_grads[n])] for n in sorted(c_grads)}}
    bad = [n for n, (err, tol) in full_width["adapter_grads"].items() if not err <= tol]
    if not (g_hidden.shape == (1, 128, cfg2.hidden_dim) and torch.isfinite(g_hidden).all()
            and full_width["hidden_max_abs_err"] <= full_width["hidden_tol"]
            and abs(g_loss - c_loss) <= full_width["loss_tol"] and math.isfinite(g_loss)
            and len(g_grads) == len(c_grads) == 8 and not bad):
        emit(phase, full_width=full_width)
        raise AssertionError("{}: full-width Llama off the CPU path: {}".format(
            phase, bad or full_width))
    return full_width


def llama_sweep_phase(phase, name, path, exp_dir, make_cfg):
    """The LoRA sweep of a Llama-family config (``llama_lora_sweep``) with
    its trainers, batches and loss: ``make_cfg(lora_rank, lora_alpha)`` is
    a trial's config, the base frozen in bf16, only the adapters trained,
    batches of LLAMA_B x LLAMA_S tokens, the vocab-chunked loss. Checks the
    warm reading and records ``path``'s captures; returns (sweep, the warm
    reading, tokens, batch, make_trainer)."""
    from maggy_tpu_torch.models import Llama
    from maggy_tpu_torch.ops import chunked_next_token_loss
    from maggy_tpu_torch.train import Trainer, adamw, only_lora

    base = make_cfg(16, 16.0)
    tokens = llama_tokens(base.vocab_size)

    def batch(i):
        t = tokens[i % tokens.shape[0]]
        return {"inputs": (t,), "tokens": t}

    def loss_fn(out, b):
        return chunked_next_token_loss(out[0], out[1], b["tokens"])

    def make_trainer(lora_rank, lora_alpha, lr, warm_start=None):
        cfg = make_cfg(int(lora_rank), float(lora_alpha))
        return Trainer(Llama(cfg, device="meta"), only_lora(adamw(lr)), loss_fn,
                       device="cuda", train_kwargs={"return_hidden": True},
                       warm_start=warm_start).init(seed=0), None

    sweep = llama_lora_sweep(phase, name, exp_dir, make_trainer, batch, base.num_layers)
    # The sweep may step eagerly only where a capture raised (out of memory
    # beside the other runner's base, say): then the reason and the peak
    # memory are printed.
    reading_warm = warm_reading(phase, sweep["telemetry"], sweep["before"], must_capture=False)
    if not reading_warm["captured"] and not reading_warm["graph_failures"]:
        emit(phase, warm=reading_warm)
        raise AssertionError("{} stepped eagerly without a failed capture: {}".format(
            phase, reading_warm))
    CAPTURED[path] = reading_warm["captured"]
    gc.collect()
    torch.cuda.empty_cache()
    return sweep, reading_warm, tokens, batch, make_trainer


def phase_slice_llama(exp_dir):
    from maggy_tpu_torch.models import LlamaConfig
    from maggy_tpu_torch.ops import chunked_next_token_loss
    from maggy_tpu_torch.train import clear_warm

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    def make_cfg(lora_rank, lora_alpha):
        return dataclasses.replace(LlamaConfig.llama3_8b(lora_rank=lora_rank),
                                   lora_alpha=lora_alpha, num_layers=LLAMA_LAYERS)

    sweep, reading_warm, tokens, batch, make_trainer = llama_sweep_phase(
        "slice_llama", "llama3_8b_lora_asha_smoke", "llama3_8b", exp_dir, make_cfg)
    result, telemetry = sweep["result"], sweep["telemetry"]
    base = make_cfg(16, 16.0)
    full_width = llama_full_width("slice_llama", dataclasses.replace(
        LlamaConfig.llama3_8b(lora_rank=16), num_layers=1), tokens)

    # The chunked loss at the sweep's shape (bf16 hidden, frozen bf16 head):
    # forward alone, and forward + backward (its gradient products in fp32).
    g = torch.Generator(device="cuda").manual_seed(4)
    hid = torch.randn(LLAMA_B, LLAMA_S, base.hidden_dim, device="cuda",
                      generator=g).to(torch.bfloat16).requires_grad_()
    head = (0.02 * torch.randn(base.hidden_dim, base.vocab_size, device="cuda",
                               generator=g)).to(torch.bfloat16)

    def loss_fwd():
        with torch.no_grad():
            chunked_next_token_loss(hid, head, tokens[0])

    def loss_fwd_bwd():
        torch.autograd.grad(chunked_next_token_loss(hid, head, tokens[0]), hid)

    loss_ms = {"fwd": gpu_time_ms(loss_fwd, reps=5), "fwd_bwd": gpu_time_ms(loss_fwd_bwd, reps=5)}
    # Whether torch.mm(..., out_dtype=float32) has a derivative here (the
    # chunked loss calls it only where no gradient flows through it).
    a = torch.ones(16, 16, device="cuda", dtype=torch.bfloat16, requires_grad=True)
    try:
        torch.mm(a, a.detach(), out_dtype=torch.float32).sum().backward()
        mm_out_dtype_differentiable = True
    except RuntimeError:
        mm_out_dtype_differentiable = False
    del hid, head, a
    gc.collect()
    torch.cuda.empty_cache()

    # Per-step time of one trainer alone on the card, eager then replayed
    # from its graph, then three profiled steps as the sweep runs them.
    alone, graph_trainer = alone_step_ms(
        lambda ws: make_trainer(16, 16.0, 1e-4, warm_start=ws)[0], batch, warmup=2, n=3,
        pairs=1)
    profile = step_device_profile(lambda i: graph_trainer.step(batch(i)), steps=3)
    alone_graph_ok = graph_trainer._slot.graph_ok
    del graph_trainer
    clear_warm()

    emit("slice_llama", trials_finished=sweep["trials_finished"], promoted=sweep["promoted"],
         best_hp=result["best_hp"], best_val=result["best_val"], steps=sweep["steps"],
         launches=sweep["launches"], expected_launches=sweep["expected"],
         sweep_wall_s=sweep["wall"], step_ms_in_sweep_median=float(np.median(sweep["step_ms"])),
         step_ms_alone=alone["graph"][0], step_ms_alone_eager=alone["eager"][0],
         alone_graph_ok=alone_graph_ok, step_profile=profile, warm=reading_warm,
         peak_mem_gb_pr9=65.51, pipeline=pipeline_summary(result["pipeline"]),
         telemetry=public(telemetry), full_width=full_width, chunked_loss_ms=loss_ms,
         mm_out_dtype_differentiable=mm_out_dtype_differentiable,
         peak_mem_sweep_gb=sweep["peak_sweep"] / 1e9,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
         phase_s=time.perf_counter() - t_phase)
    return sweep["launches"]


def danube_config(lora_rank=16, lora_alpha=16.0, num_layers=DANUBE_LAYERS):
    """H2O-Danube-1.8B's widths (arXiv:2401.16818, Table 1): vocab 32000,
    hidden 2560, FFN 6912, 24 layers, 32 query and 8 kv heads of head_dim
    80, rope theta 1e4, RMSNorm eps 1e-5, context 16384; untied embeddings,
    about 1.83 B parameters (24 x 69.5 M + 2 x 81.9 M). Its sliding window
    of 4096 keys covers the sweep's 2048 tokens, so the repo's Llama (full
    causal attention) computes the same function. Weights are seeded; the
    LoRA adapters are this repo's."""
    from maggy_tpu_torch.models import LlamaConfig

    return LlamaConfig(vocab_size=32000, hidden_dim=2560, intermediate_dim=6912,
                       num_layers=num_layers, num_heads=32, num_kv_heads=8, head_dim=80,
                       max_seq_len=16384, rope_theta=10000.0, norm_eps=1e-5,
                       lora_rank=int(lora_rank), lora_alpha=float(lora_alpha))


def phase_slice_danube(exp_dir):
    """slice_llama's LoRA sweep at H2O-Danube-1.8B's widths, DANUBE_LAYERS
    deep: the flash kernels at D=80 on the main path, with slice_llama's
    gates."""
    from maggy_tpu_torch.train import clear_warm

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    sweep, reading_warm, tokens, _, _ = llama_sweep_phase(
        "slice_danube", "danube_1_8b_lora_asha_smoke", "danube_1_8b", exp_dir, danube_config)
    result = sweep["result"]
    full_width = llama_full_width("slice_danube", danube_config(num_layers=1), tokens)
    del tokens
    clear_warm()
    emit("slice_danube", trials_finished=sweep["trials_finished"], promoted=sweep["promoted"],
         best_hp=result["best_hp"], best_val=result["best_val"], steps=sweep["steps"],
         layers=DANUBE_LAYERS, head_dim=80, launches=sweep["launches"],
         expected_launches=sweep["expected"], sweep_wall_s=sweep["wall"],
         step_ms_in_sweep_median=float(np.median(sweep["step_ms"])), warm=reading_warm,
         pipeline=pipeline_summary(result["pipeline"]), telemetry=public(sweep["telemetry"]),
         full_width=full_width, peak_mem_sweep_gb=sweep["peak_sweep"] / 1e9,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
         phase_s=time.perf_counter() - t_phase)
    return sweep["launches"]


def lora_lanes_config(num_layers):
    """slice_lora_lanes' model: Llama-3-8B's widths with rank-16 adapters
    (lora_alpha 16) and remat, ``num_layers`` of its 32 layers."""
    from maggy_tpu_torch.models import LlamaConfig

    return dataclasses.replace(LlamaConfig.llama3_8b(lora_rank=16), lora_alpha=16.0,
                               num_layers=num_layers)


def lora_adamw(learning_rate):
    """The LoRA lane family (train/vmap.py): a factory of only_lora builders
    of AdamW at ``learning_rate``."""
    from maggy_tpu_torch.train import adamw, only_lora

    return only_lora(adamw(learning_rate))


def lora_unit_reading(vt, cfg):
    """What a LoRA VmapTrainer's K-lane unit holds: the frozen parameters'
    bytes against one base's (every non-adapter parameter of ``cfg`` in the
    compute dtype), the stacked adapters', their gradient buffer's and
    AdamW's state's bytes; and what is wrong: a frozen parameter held twice,
    stacked, with a gradient buffer or optimizer state, trainable or in
    another dtype, or a stacked one that is no adapter."""
    from maggy_tpu_torch.models import Llama
    from maggy_tpu_torch.train import is_lora_param

    unit = vt._unit

    def nbytes(tensors):
        return sum(t.numel() * t.element_size() for t in tensors)

    state = [v for st in unit.optimizer.state.values() for v in st.values()
             if isinstance(v, torch.Tensor)]
    itemsize = torch.empty((), dtype=cfg.dtype).element_size()
    base = itemsize * sum(p.numel() for n, p in Llama(cfg, device="meta").named_parameters()
                          if not is_lora_param(n))
    frozen = [t.data_ptr() for t in unit.frozen.values()]
    trained = {t.data_ptr() for t in list(unit.stacked.values()) + list(unit.grads.values())
               + state}
    trained |= {p.data_ptr() for g in unit.optimizer.param_groups for p in g["params"]}
    reading = {"lanes": vt.k, "frozen_params": len(unit.frozen), "frozen_bytes":
               nbytes(unit.frozen.values()), "base_bytes": base,
               "stacked_params": len(unit.stacked), "stacked_bytes": nbytes(unit.stacked.values()),
               "grad_bytes": nbytes(unit.grads.values()), "optimizer_state_bytes": nbytes(state)}
    problems = []
    if reading["frozen_bytes"] != base:
        problems.append("frozen bytes {} != one base's {}".format(reading["frozen_bytes"], base))
    if len(set(frozen)) != len(frozen) or set(frozen) & trained:
        problems.append("a frozen parameter is held twice, stacked or optimized")
    if not all(is_lora_param(n) for n in unit.stacked) or \
            any(is_lora_param(n) for n in unit.frozen):
        problems.append("stacked {} / frozen {} names".format(len(unit.stacked),
                                                               len(unit.frozen)))
    if any(t.dtype != cfg.dtype or t.requires_grad for t in unit.frozen.values()):
        problems.append("a frozen parameter is trainable or not in {}".format(cfg.dtype))
    reading["problems"] = problems
    return reading


def lora_lanes_full_depth(batch, loss_fn):
    """slice_lora_lanes (b): one VmapTrainer of LORA_LANES_K LoRA lanes of
    the whole 32-layer Llama-3-8B (remat, the chunked loss), eager, for
    LORA_LANES_FULL_STEPS steps. lora_b starts at zero, so every lane's
    first loss is the base's: each against the unit module's own eager
    forward on the same batch, within AB_LOSS_TOL["bert_base"] (bf16
    arithmetic: the lanes' products fold the lanes into their rows, the
    eager forward's do not). Returns (line, problems, launches)."""
    from maggy_tpu_torch.models import Llama
    from maggy_tpu_torch.ops import attention as A
    from maggy_tpu_torch.ops import chunked_next_token_loss
    from maggy_tpu_torch.train.vmap import VmapTrainer

    cfg = lora_lanes_config(32)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    vt = VmapTrainer(Llama(cfg, device="meta"), lora_adamw,
                     [{"learning_rate": lr} for lr in LORA_LANES_FULL_LRS], loss_fn,
                     device="cuda", train_kwargs={"return_hidden": True},
                     warm_start=False).init(seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    peak_init = torch.cuda.max_memory_allocated()
    first = batch(0)
    with torch.no_grad():
        hidden, head = vt.model(first["inputs"][0], return_hidden=True)
        eager = float(chunked_next_token_loss(hidden, head, first["tokens"]))
    del hidden, head
    torch.cuda.reset_peak_memory_stats()
    A.reset_launch_counts()
    rows = []
    t0 = time.perf_counter()
    for i in range(LORA_LANES_FULL_STEPS):
        rows.append(vt.step(batch(i)))
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / LORA_LANES_FULL_STEPS
    launches = A.launch_counts()
    peak_steps = torch.cuda.max_memory_allocated()
    losses = torch.stack(rows).float().cpu().numpy()
    unit = lora_unit_reading(vt, cfg)
    del vt, rows
    gc.collect()
    torch.cuda.empty_cache()
    rel, absolute = AB_LOSS_TOL["bert_base"]
    off = float(np.max(np.abs(losses[0] - eager) - (rel * abs(eager) + absolute)))
    steps = LORA_LANES_FULL_STEPS
    expected = {"flash_fwd": 2 * cfg.num_layers * steps,
                "flash_bwd_dkdv": cfg.num_layers * steps, "flash_bwd_dq": cfg.num_layers * steps}
    line = {"lanes": LORA_LANES_K, "layers": cfg.num_layers, "batch": [LLAMA_B, LLAMA_S],
            "steps": steps, "lrs": LORA_LANES_FULL_LRS, "losses": losses.tolist(),
            "eager_forward_loss": eager, "first_loss_excess_over_tol": off,
            "tol": {"relative": rel, "absolute": absolute}, "launches": launches,
            "expected_launches": expected, "init_s": init_s, "step_ms_eager": step_ms,
            "unit": unit, "peak_mem_init_gb": peak_init / 1e9,
            "peak_mem_steps_gb": peak_steps / 1e9, "reckoning_gb": LORA_LANES_RECKONING_GB,
            "scalar_32_layer_sweep_peak_gb": SCALAR_32_LAYER_PEAK_GB}
    problems = ["full depth: " + p for p in unit["problems"]]
    if off > 0 or not np.isfinite(losses).all():
        problems.append("full depth: first losses {} off the eager forward's {} by {} over "
                        "the tolerance".format(losses[0].tolist(), eager, off))
    if launches != expected:
        problems.append("full depth: launches {} != {}".format(launches, expected))
    return line, problems, launches


def phase_slice_lora_lanes(exp_dir):
    """Vectorized LoRA lanes of Llama-3-8B (train/vmap.py's LoRA family,
    models/remat.py, ops/losses.py's batching rule): (a) the sweep through
    lagom, (b) the full depth. See the module docstring."""
    from maggy_tpu_torch import OptimizationConfig, Searchspace, experiment
    from maggy_tpu_torch.models import Llama
    from maggy_tpu_torch.ops import attention as A
    from maggy_tpu_torch.ops import chunked_next_token_loss
    from maggy_tpu_torch.train import Trainer, adamw, clear_warm, only_lora, swept_transform, warm
    from maggy_tpu_torch.train.vmap import VmapTrainer

    phase = "slice_lora_lanes"
    t_phase = time.perf_counter()
    clear_warm()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = lora_lanes_config(LLAMA_LAYERS)
    tokens = llama_tokens(cfg.vocab_size)

    def batch(i):
        t = tokens[i % tokens.shape[0]]
        return {"inputs": (t,), "tokens": t}

    def loss_fn(out, b):
        return chunked_next_token_loss(out[0], out[1], b["tokens"])

    lock = threading.Lock()
    dispatches = []

    def train_lora_lanes(lr, reporter, lanes=None):
        """A trial of the sweep: a block's lanes as one VmapTrainer of the
        LoRA family, a scalar dispatch as a Trainer of the same family;
        each step timed alone and its losses kept, each unit read."""
        if lanes is None:
            trainer = Trainer(Llama(cfg, device="meta"),
                              swept_transform(lora_adamw, learning_rate=lr), loss_fn,
                              device="cuda", train_kwargs={"return_hidden": True}).init(seed=0)
            step, lrs, ids = trainer.step, [lr], [reporter.trial_id]
        else:
            vt = VmapTrainer(Llama(cfg, device="meta"), lora_adamw,
                             [{"learning_rate": h["lr"]} for h in lanes.hparams], loss_fn,
                             device="cuda", train_kwargs={"return_hidden": True}).init(seed=0)
            step, lrs, ids = vt.step, [h["lr"] for h in lanes.hparams], list(lanes.trial_ids)
        rows, step_ms = [], []
        for i in range(LORA_LANES_STEPS):
            stream_sync()
            t0 = time.perf_counter()
            losses = step(batch(i))
            stream_sync()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            rows.append(losses.float().reshape(-1))
            if lanes is None:
                reporter.broadcast(-losses, step=i)
                continue
            reporter.broadcast_lanes(-losses, step=i)
            stopped = lanes.take_stopped()
            if stopped:
                values = (-losses).tolist()
                for lane in stopped:
                    vt.mask_lane(lane)
                    lanes.retire(lane, values[lane])
        final = rows[-1].tolist()
        record = {"kind": "scalar" if lanes is None else "block", "lrs": lrs, "trials": ids,
                  "losses": torch.stack(rows).cpu().numpy().tolist(), "step_ms": step_ms}
        if lanes is not None:
            record["unit_id"] = id(vt._unit)
            record["unit"] = lora_unit_reading(vt, cfg)
        with lock:
            dispatches.append(record)
        if not np.isfinite(final).all():
            raise FloatingPointError("non-finite losses {}".format(final))
        if lanes is None:
            return {"metric": -final[0]}
        return {tid: -final[i] for i, tid in enumerate(ids)}

    config = OptimizationConfig(
        name="llama3_8b_lora_lanes_smoke", num_trials=LORA_LANES_TRIALS,
        optimizer="randomsearch", searchspace=Searchspace(lr=("DOUBLE_LOG", [1e-5, 1e-3])),
        direction="max", num_workers=1, es_policy="median", vmap_lanes=LORA_LANES_K,
        hb_interval=0.1, seed=0, experiment_dir=exp_dir)
    before = warm.counters()
    A.reset_launch_counts()
    t0 = time.perf_counter()
    result = experiment.lagom(train_lora_lanes, config)
    wall = time.perf_counter() - t0
    launches = A.launch_counts()
    telemetry = journal_check(phase, exp_dir, result)
    reading_warm = warm_reading(phase, telemetry, before)
    peak_sweep = torch.cuda.max_memory_allocated()
    clear_warm()
    gc.collect()
    torch.cuda.empty_cache()

    problems = []
    blocks = [d for d in dispatches if d["kind"] == "block"]
    scalars = [d for d in dispatches if d["kind"] == "scalar"]
    ids = [t for d in dispatches for t in d["trials"]]
    if not (result["num_trials"] == LORA_LANES_TRIALS == len(ids) == len(set(ids))):
        problems.append("{} trials, {} dispatched ({} distinct), of {}".format(
            result["num_trials"], len(ids), len(set(ids)), LORA_LANES_TRIALS))
    sizes = [len(d["trials"]) for d in blocks]
    if sizes != [LORA_LANES_K, LORA_LANES_K] or blocks[1]["unit_id"] != blocks[0]["unit_id"]:
        problems.append("blocks {}: want two of {} lanes, the second on the first's retired "
                        "unit".format(sizes, LORA_LANES_K))
    total_steps = sum(len(d["step_ms"]) for d in dispatches)
    expected = {"flash_fwd": 2 * cfg.num_layers * total_steps,
                "flash_bwd_dkdv": cfg.num_layers * total_steps,
                "flash_bwd_dq": cfg.num_layers * total_steps}
    if launches != expected:
        problems.append("launches {} != {} (a block step launches each kernel once a layer "
                        "for all lanes; remat: the forward twice)".format(launches, expected))
    if not (reading_warm["eager_steps"] == reading_warm["warm_misses"]
            and reading_warm["graph_replays"] == total_steps - reading_warm["eager_steps"]):
        problems.append("steps after a unit's first not all replayed: {} of {}".format(
            reading_warm, total_steps))
    for d in blocks:
        problems += ["unit: " + p for p in d["unit"]["problems"]]

    # The lanes with the smallest and the largest rate against a scalar
    # Trainer of only_lora(adamw(lr)) at the same seed, rate and batches.
    rel, absolute = AB_LOSS_TOL["bert_base"]
    lanes_by_lr = sorted(((lr, np.asarray(d["losses"])[:, i]) for d in blocks
                          for i, lr in enumerate(d["lrs"])), key=lambda pair: pair[0])
    against_scalar = []
    for lr, lane in (lanes_by_lr[:1] + lanes_by_lr[-1:]):
        trainer = Trainer(Llama(cfg, device="meta"), only_lora(adamw(lr)), loss_fn,
                          device="cuda", train_kwargs={"return_hidden": True}).init(seed=0)
        ref = np.asarray([float(trainer.step(batch(i))) for i in range(LORA_LANES_STEPS)])
        del trainer
        clear_warm()
        excess = float(np.max(np.abs(lane - ref) - (rel * np.abs(ref) + absolute)))
        against_scalar.append({"lr": lr, "lane": lane.tolist(), "scalar": ref.tolist(),
                               "excess_over_tol": excess})
        if not excess <= 0:
            problems.append("the lane at lr {} is off its scalar Trainer by {} over the "
                            "tolerance".format(lr, excess))
    CAPTURED["llama3_8b_lora_lanes"] = reading_warm["captured"]
    replayed_block_ms = [ms for d in blocks for ms in d["step_ms"][1:]]
    fields = dict(
        trials=result["num_trials"], best_hp=result["best_hp"], best_val=result["best_val"],
        blocks=sizes, scalar_dispatches=len(scalars), layers=cfg.num_layers,
        batch=[LLAMA_B, LLAMA_S], steps=total_steps, launches=launches,
        expected_launches=expected, warm=reading_warm,
        block_step_ms_p50=float(np.median(replayed_block_ms)) if replayed_block_ms else None,
        block_first_step_ms=[d["step_ms"][0] for d in blocks],
        scalar_step_ms_p50=float(np.median([ms for d in scalars for ms in d["step_ms"][1:]]))
        if scalars else None,
        unit=blocks[0]["unit"] if blocks else None, against_scalar=against_scalar,
        tol={"relative": rel, "absolute": absolute}, sweep_wall_s=wall,
        peak_mem_sweep_gb=peak_sweep / 1e9, reckoning_sweep_gb=LORA_LANES_SWEEP_RECKONING_GB,
        pipeline=pipeline_summary(result["pipeline"]), telemetry=public(telemetry))
    gc.collect()
    torch.cuda.empty_cache()
    torch._C._cuda_clearCublasWorkspaces()
    try:
        full, full_problems, _ = lora_lanes_full_depth(batch, loss_fn)
    except BaseException as e:
        emit(phase, **fields, problems=problems, full_depth_error=repr(e)[:1000],
             phase_s=time.perf_counter() - t_phase)
        raise
    problems += full_problems
    emit(phase, **fields, full_depth=full, problems=problems,
         phase_s=time.perf_counter() - t_phase)
    if problems:
        raise AssertionError("{}: {}".format(phase, "; ".join(problems)))
    return launches


@contextlib.contextmanager
def example_dirs(exp_dir):
    """An example's run dirs (MAGGY_TPU_BASE_DIR), dataset registry
    (MAGGY_TPU_REGISTRY_ROOT) and temporary files, all under ``exp_dir``,
    with the environment singleton rebuilt over them; restored after.
    Yields the base dir its runs land in."""
    import tempfile

    from maggy_tpu_torch.core.environment.singleton import EnvSing

    base = fresh_dir(os.path.join(exp_dir, "exp"))
    keys = ("MAGGY_TPU_BASE_DIR", "MAGGY_TPU_REGISTRY_ROOT")
    saved, saved_tmp = {k: os.environ.get(k) for k in keys}, tempfile.tempdir
    os.environ.update(MAGGY_TPU_BASE_DIR=base,
                      MAGGY_TPU_REGISTRY_ROOT=fresh_dir(os.path.join(exp_dir, "registry")))
    tempfile.tempdir = fresh_dir(os.path.join(exp_dir, "tmp"))
    EnvSing.reset()
    try:
        yield base
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        tempfile.tempdir = saved_tmp
        EnvSing.reset()


def run_example(exp_root, name, settings=None):
    """``maggy_tpu_torch.examples.<name>.main(EXAMPLE_ARGS[name])`` in this
    process, the module's ``settings`` (name -> value, or a function of the
    module giving it) set for the run and restored after. Checks the
    printed lines, the finalized trials and the journal; returns (the
    phase line's summary, the trials)."""
    import importlib

    from maggy_tpu_torch.train import clear_warm

    mod = importlib.import_module("maggy_tpu_torch.examples." + name)
    settings = settings or {}
    saved = {k: getattr(mod, k) for k in settings}
    out = io.StringIO()
    with example_dirs(os.path.join(exp_root, name)) as base:
        try:
            for k, v in settings.items():
                setattr(mod, k, v(mod) if callable(v) else v)
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                result = mod.main(list(EXAMPLE_ARGS[name]))
            wall = time.perf_counter() - t0
        finally:
            for k, v in saved.items():
                setattr(mod, k, v)
            clear_warm()
        lines = out.getvalue().splitlines()
        summary = {"wall_s": wall, "printed": lines}
        if name == "distributed_training":
            journal = dist_journal_check(name, base, 1)
            problems = journal.pop("problems")
            if not (lines and lines[-1].startswith("Average final loss across workers:")
                    and math.isfinite(result["average_metric"])):
                problems.append("result {}, printed {}".format(result, lines))
            if problems:
                raise AssertionError("slice_examples {}: {}".format(name, "; ".join(problems)))
            summary.update(average_metric=result["average_metric"], journal=journal)
            return summary, []
        trials = read_trials(base)
        finished = [t for t in trials if t["status"] == "FINALIZED"
                    and t["final_metric"] is not None and math.isfinite(t["final_metric"])]
        if not (len(trials) == len(finished) == result["num_trials"] == EXAMPLE_TRIALS[name]
                and math.isfinite(result["best_val"]) and lines
                and lines[0].startswith(("Best", "Trials:"))):
            emit("slice_examples", failed=name, printed=lines, trials=len(trials),
                 finished=len(finished), result_trials=result["num_trials"])
            raise AssertionError("slice_examples {}: {} of {} trials finalized".format(
                name, len(finished), EXAMPLE_TRIALS[name]))
        summary.update(trials=len(finished), best_val=result["best_val"],
                       best_hp=result["best_hp"],
                       telemetry=public(journal_check("slice_examples " + name, base, result)))
        return summary, trials


def example_launches(name, trials, expected, before, summary):
    """Hold a full-width example's kernel launches to ``expected`` and its
    steps to CUDA graphs (a capture that failed is printed and allowed
    only for the Llama, as in slice_llama); returns the launches."""
    from maggy_tpu_torch.ops import attention as A

    launches = A.launch_counts()
    reading = warm_reading("slice_examples " + name, None, before,
                           must_capture=name == "bert_glue_hpo")
    if not reading["captured"] and not reading["graph_failures"]:
        raise AssertionError("slice_examples {} stepped eagerly without a failed capture: "
                             "{}".format(name, reading))
    summary.update(launches=launches, expected_launches=expected, warm=reading,
                   peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    if launches != expected or any(t.get("early_stop") for t in trials):
        emit("slice_examples", failed=name, **summary)
        raise AssertionError("slice_examples {} launches {} != {}".format(
            name, launches, expected))
    return launches, reading["captured"]


def phase_slice_examples(exp_root):
    """The port's examples as a user runs them: the python -m entry, the
    tiny examples in this process, and bert_glue_hpo and llama_lora_sweep
    at full width through the flash kernels (see the module docstring)."""
    from maggy_tpu_torch.models import BertConfig, LlamaConfig
    from maggy_tpu_torch.ops import attention as A
    from maggy_tpu_torch.train import warm

    t_phase = time.perf_counter()
    exp_root = fresh_dir(exp_root)
    examples, launches = {}, {}

    # 1. The CLI entry, on the card: no device variable in its environment.
    exp_dir = fresh_dir(os.path.join(exp_root, "mnist_hpo_cli"))
    env = {k: v for k, v in os.environ.items() if k != "MAGGY_TPU_TORCH_DEVICE"}
    env["MAGGY_TPU_BASE_DIR"] = exp_dir
    cmd = [sys.executable, "-m", "maggy_tpu_torch.examples.mnist_hpo",
           *EXAMPLE_ARGS["mnist_hpo"]]
    t_spawn, t0 = time.time(), time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        out, err = proc.communicate(timeout=EXAMPLE_CLI_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    wall = time.perf_counter() - t0
    lines = out.splitlines()
    trials = read_trials(exp_dir)
    if not (proc.returncode == 0 and any(line.startswith("Best: ") for line in lines)
            and len(trials) == EXAMPLE_TRIALS["mnist_hpo"]
            and all(t["status"] == "FINALIZED" for t in trials)):
        emit("slice_examples", failed="mnist_hpo_cli", rc=proc.returncode, stdout=lines[-20:],
             stderr=err.splitlines()[-40:], trials=len(trials))
        raise AssertionError("python -m maggy_tpu_torch.examples.mnist_hpo: rc {}, {} "
                             "trials".format(proc.returncode, len(trials)))
    result = {"num_trials": len(trials), "pipeline": json.load(open(glob.glob(os.path.join(
        exp_dir, "*", "result.json"))[0]))["pipeline"]}
    telemetry = journal_check("slice_examples mnist_hpo_cli", exp_dir, result)
    first_event = min(e["t"] for e in telemetry["_events"])
    examples["mnist_hpo_cli"] = {"wall_s": wall, "startup_s": first_event - t_spawn,
                                 "trials": len(trials), "printed": lines,
                                 "telemetry": public(telemetry)}

    # 2. The other tiny examples, in this process.
    for name in ("resnet_cifar_asha", "vit_cifar_hpo", "pbt_sweep", "titanic_ablation",
                 "distributed_training"):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        summary, _ = run_example(exp_root, name)
        summary["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        examples[name] = summary

    # 3. bert_glue_hpo at BERT-base's widths on its own tokens at length 128.
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = BertConfig.base(num_classes=2)
    before = warm.counters()
    A.reset_launch_counts()
    summary, trials = run_example(exp_root, "bert_glue_hpo", {
        "CONFIG": cfg, "TOKENS": lambda m: m.make_sst_like(seq=BERT_S)[0],
        "LABELS": lambda m: m.make_sst_like(seq=BERT_S)[1]})
    steps = len(trials) * BERT_EXAMPLE_STEPS
    expected = {"flash_fwd": cfg.num_layers * (steps + len(trials)),
                "flash_bwd_dkdv": cfg.num_layers * steps, "flash_bwd_dq": cfg.num_layers * steps}
    launches["bert_base_examples"], CAPTURED["bert_base_examples"] = example_launches(
        "bert_glue_hpo", trials, expected, before, summary)
    summary.update(steps=steps, trial_s_per_step=sorted(
        t["duration"] / BERT_EXAMPLE_STEPS for t in trials))
    examples["bert_glue_hpo"] = summary

    # 4. llama_lora_sweep at Llama-3-8B's widths, 4 of 32 layers.
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(LlamaConfig.llama3_8b(), num_layers=LLAMA_LAYERS)
    before = warm.counters()
    A.reset_launch_counts()
    summary, trials = run_example(exp_root, "llama_lora_sweep", {
        "CONFIG": cfg, "ROWS": LLAMA_B, "SEQ": LLAMA_S, "VOCAB_CHUNK": LLAMA_EXAMPLE_VOCAB_CHUNK,
        "CORPUS": lambda m: m.make_corpus(seq=LLAMA_S, vocab=cfg.vocab_size)})
    steps = len(trials) * LLAMA_EXAMPLE_STEPS
    expected = {"flash_fwd": 2 * cfg.num_layers * steps, "flash_bwd_dkdv": cfg.num_layers * steps,
                "flash_bwd_dq": cfg.num_layers * steps}
    launches["llama3_8b_examples"], CAPTURED["llama3_8b_examples"] = example_launches(
        "llama_lora_sweep", trials, expected, before, summary)
    summary.update(steps=steps, trial_s_per_step=sorted(
        t["duration"] / LLAMA_EXAMPLE_STEPS for t in trials))
    examples["llama_lora_sweep"] = summary
    gc.collect()
    torch.cuda.empty_cache()

    emit("slice_examples", examples=examples, launches=launches,
         phase_s=time.perf_counter() - t_phase)
    return launches


def mnist_sweep(exp_dir, pool, fn_kw=None, **config_kw):
    """bench.py's headline sweep (run_framework_sweep: ASHA(3, 1, 9) +
    median stopping over lr and batch, 18 rung-0 trials, 3 runners) on
    ``pool``: (result, wall s, trials, records)."""
    from maggy_tpu_torch import OptimizationConfig, Searchspace, experiment
    from maggy_tpu_torch.optimizers import Asha

    out_dir = fresh_dir(os.path.join(exp_dir, "records"))
    trial_dir = fresh_dir(os.path.join(exp_dir, "exp"))
    sp = Searchspace(lr=("DOUBLE_LOG", [1e-4, 3e-2]), batch=("DISCRETE", MNIST_BATCHES))
    config = OptimizationConfig(
        name="bench_asha", num_trials=18,
        optimizer=Asha(reduction_factor=3, resource_min=1, resource_max=9, seed=0),
        searchspace=sp, direction="max", num_workers=3, hb_interval=0.1, es_policy="median",
        es_interval=1, es_min=3, seed=0, experiment_dir=trial_dir, pool=pool, **config_kw)
    t0 = time.perf_counter()
    result = experiment.lagom(functools.partial(train_mnist, out_dir=out_dir, **(fn_kw or {})),
                              config)
    wall = time.perf_counter() - t0
    return result, wall, read_trials(trial_dir), read_records(out_dir)


def runner_logs(exp_dir, n=80):
    """The last ``n`` lines of a sweep's runner logs (a failed trial's
    traceback among them)."""
    lines = [line for path in sorted(glob.glob(os.path.join(exp_dir, "*", "executor_*.log")))
             for line in open(path, errors="replace").read().splitlines()]
    return "\n".join(lines[-n:])


def check_mnist_sweep(name, pool, result, trials, records, exp_dir):
    """Every trial finalized once with its record, promotions, a finite best
    value, steps taken; process runners other than the driver. A failure
    shows the runners' logs."""
    ids = [t["id"] for t in trials]
    problems = []
    if not (len(ids) == len(set(ids)) == result["num_trials"] > 0
            and all(t["status"] == "FINALIZED" for t in trials)
            and math.isfinite(result["best_val"])):
        problems.append("{} trials, {} finalized, result {}".format(
            len(ids), sum(t["status"] == "FINALIZED" for t in trials), result["num_trials"]))
    if not any(t["info_dict"].get("sample_type") == "promoted" for t in trials):
        problems.append("no promoted trial")
    if set(ids) - {r["trial_id"] for r in records} or not sum(r["steps"] for r in records):
        problems.append("trials without a step record")
    pids = {r["pid"] for r in records}
    if (os.getpid() in pids) != (pool == "thread"):
        problems.append("trials ran in processes {} (driver {})".format(sorted(pids), os.getpid()))
    if problems:
        raise AssertionError("{}: {}; runner logs:\n{}".format(name, "; ".join(problems),
                                                              runner_logs(exp_dir)))


def mnist_summary(result, wall, trials, records):
    return {"sweep_wall_s": wall, "trials_finished": len(trials),
            "promoted": sum(t["info_dict"].get("sample_type") == "promoted" for t in trials),
            "early_stopped": result["early_stopped"], "best_val": result["best_val"],
            "steps": sum(r["steps"] for r in records),
            "step_ms_in_sweep_median": float(np.median([r["step_ms"] for r in records])),
            "runner_processes": len({r["pid"] for r in records}),
            "time_split": time_split(records), "lost_runners": result["lost_runners"]}


def phase_slice_mnist(exp_root):
    """bench.py's headline on the card under thread and process runners,
    after the card's logits against the CPU's for one batch."""
    from maggy_tpu_torch.train import ShardedBatchIterator, clear_warm, warm

    gc.collect()
    torch.cuda.empty_cache()
    X, Y = cached("mnist", make_data)
    model = mnist_model(DEVICE)
    model.init_weights(torch.Generator(device=DEVICE).manual_seed(0))
    b = next(iter(ShardedBatchIterator({"x": X, "y": Y}, batch_size=MNIST_BATCHES[0],
                                       seed=1, device=DEVICE)))
    with torch.no_grad():
        gpu_logits = model(b["x"]).cpu()
        cpu_logits = copy.deepcopy(model).to("cpu")(b["x"].cpu())
    # fp32 on both sides with TF32 off (full_fp32): cuDNN and oneDNN sum in
    # other orders, a few ulps of each logit.
    logit_err = float((gpu_logits - cpu_logits).abs().max())
    logit_tol = 1e-4 * float(cpu_logits.abs().max()) + 1e-5
    if not (torch.isfinite(gpu_logits).all() and logit_err <= logit_tol
            and gpu_logits.shape == (MNIST_BATCHES[0], 2)):
        raise AssertionError("MNIST CNN logits off the CPU path: {} > {}".format(
            logit_err, logit_tol))
    sweeps = {}
    # Then the thread sweep with telemetry off and on in turns: its cost
    # where the host sets the pace, both sides warm.
    pairs = [("thread_telemetry_{}_1".format("on" if on else "off"), "thread", on)
             for on in (False, True)]
    for label, pool, on in [("thread", "thread", True), ("process", "process", True)] + pairs:
        name = "slice_mnist/" + label
        exp_dir = os.path.join(exp_root, label)
        clear_warm()
        before = warm.counters()
        result, wall, trials, records = mnist_sweep(exp_dir, pool, telemetry=on)
        check_mnist_sweep(name, pool, result, trials, records, os.path.join(exp_dir, "exp"))
        sweeps[label] = mnist_summary(result, wall, trials, records)
        telemetry = journal_check(name, os.path.join(exp_dir, "exp"), result) if on else None
        sweeps[label]["warm"] = warm_reading(name, telemetry,
                                             before if pool == "thread" else None)
        if on:
            sweeps[label]["telemetry"] = public(telemetry)
            if pool == "process":
                sweeps[label]["runner_setup"] = runner_setup(telemetry)
        elif glob.glob(os.path.join(exp_dir, "exp", "*", "telemetry.jsonl*")):
            raise AssertionError("{}: a journal was written with telemetry off".format(name))
    cost = {label: {"sweep_wall_s": sweeps[label]["sweep_wall_s"],
                    "wall_ms_per_step": 1e3 * sweeps[label]["sweep_wall_s"] / sweeps[label]["steps"],
                    **{k: sweeps[label][k] for k in ("step_ms_in_sweep_median", "trials_finished",
                                                     "steps")}}
            for label, _, _ in pairs}
    for on in ("off", "on"):
        runs = [v for k, v in cost.items() if "_{}_".format(on) in k]
        cost["median_" + on] = {k: float(np.median([r[k] for r in runs]))
                                for k in ("wall_ms_per_step", "step_ms_in_sweep_median")}
    clear_warm()
    emit("slice_mnist", logits_max_abs_err=logit_err, logits_tol=logit_tol,
         tf32=torch.backends.cudnn.allow_tf32, telemetry_cost=cost, **sweeps)


def phase_slice_recovery(exp_dir):
    """The process sweep of slice_mnist with two runners faulting mid-trial:
    one exits, one freezes."""
    flags = {"kill": os.path.join(exp_dir, "kill.flag"),
             "wedge": os.path.join(exp_dir, "wedge.flag")}
    for flag in flags.values():
        if os.path.exists(flag):
            os.remove(flag)
    result, wall, trials, records = mnist_sweep(
        os.path.join(exp_dir, "sweep"), "process",
        fn_kw={"kill_flag": flags["kill"], "wedge_flag": flags["wedge"]},
        hb_loss_timeout=RECOVERY_LOSS_TIMEOUT_S)
    faults = {}
    for kind, flag in flags.items():
        with open(flag) as f:
            faults[kind] = json.load(f)
    requeued = {r["trial_id"]: r for r in result["recovery"]["requeued"]}
    status = {t["id"]: t["status"] for t in trials}
    problems = []
    try:
        check_mnist_sweep("slice_recovery", "process", result, trials, records,
                          os.path.join(exp_dir, "sweep", "exp"))
    except AssertionError as e:
        problems.append(str(e))
    if result["lost_runners"] != 2:
        problems.append("{} lost runners, not 2".format(result["lost_runners"]))
    for kind, f in faults.items():
        reruns = [r for r in records if r["trial_id"] == f["trial_id"] and r["pid"] != f["pid"]]
        if f["trial_id"] not in requeued or status.get(f["trial_id"]) != "FINALIZED" \
                or not reruns:
            problems.append("the {} trial {} was not requeued and re-run to its end".format(
                kind, f["trial_id"]))
        else:
            f.update(partition=requeued[f["trial_id"]]["partition"],
                     fault_to_requeue_s=requeued[f["trial_id"]]["at"] - f["at"],
                     rerun_pid=reruns[0]["pid"], rerun_steps=reruns[0]["steps"])
    killed = result["recovery"]["killed"]
    if faults["wedge"].get("partition") not in killed:
        problems.append("the frozen runner was not killed (killed: {})".format(killed))
    telemetry = journal_check("slice_recovery", os.path.join(exp_dir, "sweep", "exp"), result,
                              recovery=True, trace=True)
    emit("slice_recovery", faults=faults, killed=killed, loss_timeout_s=RECOVERY_LOSS_TIMEOUT_S,
         warm=warm_reading("slice_recovery", telemetry, must_capture=False),
         stale_finals_dropped=result["recovery"]["stale_finals_dropped"],
         telemetry=public(telemetry), **mnist_summary(result, wall, trials, records))
    if problems:
        raise AssertionError("slice_recovery: {}".format("; ".join(problems)))


# ----------------------------------------- slice 11: ResNet, ViT and MoE paths


def replayed_after_warmup(name, reading, steps):
    """Every step of the sweep after a unit's first at its batch shape
    replayed a graph: one eager warm-up per capture, every other step a
    replay, no failed capture."""
    if not (reading["graph_failures"] == 0 and reading["graph_captures"] > 0
            and reading["eager_steps"] == reading["graph_captures"]
            and reading["graph_replays"] + reading["eager_steps"] == steps):
        emit(name, warm=reading, steps=steps)
        raise AssertionError("{}: {} steps did not replay after their warm-up: {}".format(
            name, steps, reading))


def tf32_settings():
    return {"cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
            "cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32}


def record_sweep(phase, exp_dir, train, **config_kw):
    """A thread-runner sweep whose trials write TrialRecords: (result, wall
    s, records, trials, the journal's telemetry, the warm reading (steps
    must replay from graphs), steps, the process's flash launches)."""
    from maggy_tpu_torch import OptimizationConfig, experiment
    from maggy_tpu_torch.ops import attention as A
    from maggy_tpu_torch.train import clear_warm, warm

    out_dir = fresh_dir(os.path.join(exp_dir, "records"))
    config = OptimizationConfig(direction="max", hb_interval=0.1, seed=0,
                                experiment_dir=fresh_dir(os.path.join(exp_dir, "exp")),
                                **config_kw)
    before = warm.counters()
    A.reset_launch_counts()
    t0 = time.perf_counter()
    result = experiment.lagom(functools.partial(train, out_dir=out_dir), config)
    wall = time.perf_counter() - t0
    launches = A.launch_counts()
    clear_warm()
    records, trials = read_records(out_dir), read_trials(os.path.join(exp_dir, "exp"))
    telemetry = journal_check(phase, os.path.join(exp_dir, "exp"), result)
    reading = warm_reading(phase, telemetry, before)
    steps = sum(r["steps"] for r in records)
    replayed_after_warmup(phase, reading, steps)
    if not (len(trials) == result["num_trials"] == len(records)
            and all(t["status"] == "FINALIZED" for t in trials)
            and math.isfinite(result["best_val"])):
        raise AssertionError("{} sweep malformed: {} trials, {} records, {}".format(
            phase, len(trials), len(records), result))
    return result, wall, records, trials, telemetry, reading, steps, launches


def sweep_fields(result, wall, records, trials, telemetry, reading, steps):
    comp = telemetry["_compile"]
    return {"trials": len(trials),
            "promoted": sum(1 for t in trials
                            if t["info_dict"].get("sample_type") == "promoted"),
            "early_stopped": result["early_stopped"], "best_hp": result["best_hp"],
            "best_val": result["best_val"], "steps": steps, "sweep_wall_s": wall,
            "step_ms_in_sweep_p50": float(np.median([r["step_ms"] for r in records])),
            "warm": reading, "warm_hits": comp.get("warm_hits", 0),
            "warm_misses": comp.get("warm_misses", 0), "compile_ms": comp.get("compile_ms"),
            "init_ms": comp.get("init_ms"), "pipeline": pipeline_summary(result["pipeline"]),
            "telemetry": public(telemetry), "time_split": time_split(records)}


def cifar_data():
    """examples/resnet_cifar_asha.py's make_cifar_like(): 1024 seeded
    32 x 32 x 3 images, label = whether the image's mean is positive, on the
    card."""
    def build():
        rng = np.random.default_rng(0)
        X = rng.normal(size=(RESNET_N, 32, 32, 3)).astype(np.float32)
        y = (X.mean(axis=(1, 2, 3)) > 0).astype(np.int64)
        return torch.as_tensor(X, device=DEVICE), torch.as_tensor(y, device=DEVICE)

    return cached("cifar", build)


def resnet_batches():
    """The example's ShardedBatchIterator (batch 128, seed 1, epochs
    without end) over the card-resident set."""
    from maggy_tpu_torch.train import ShardedBatchIterator

    X, y = cifar_data()
    for b in ShardedBatchIterator({"x": X, "y": y}, batch_size=RESNET_BATCH, epochs=None,
                                  seed=1):
        yield {"inputs": (b["x"],), "labels": b["y"]}


def resnet_trainer(lr, width, weight_decay, warm_start=None):
    """The example's trainer: ResNet(RESNET_DEPTH, 2 classes, width) in
    fp32, swept AdamW (lr on a tensor, weight decay baked into the family),
    batch statistics updated in the step."""
    from maggy_tpu_torch.models import ResNet
    from maggy_tpu_torch.train import Trainer, adamw, swept_transform

    return Trainer(ResNet(depth=RESNET_DEPTH, num_classes=2, width=int(width), device="meta"),
                   swept_transform(adamw, learning_rate=lr, weight_decay=weight_decay),
                   labels_loss, device=DEVICE, has_aux_collections=True,
                   train_kwargs={"train": True}, warm_start=warm_start).init(seed=0)


def train_resnet(lr, width, weight_decay, budget, reporter, out_dir):
    """One trial of slice_resnet: examples/resnet_cifar_asha.py's train_fn."""
    record = TrialRecord(out_dir, reporter)
    full_fp32()
    trainer = resnet_trainer(lr, width, weight_decay)
    batches = resnet_batches()
    with record:
        for step in range(int(RESNET_STEPS_PER_BUDGET * budget)):
            loss = trainer.step(next(batches))
            record.steps += 1
            if step % RESNET_REPORT_EVERY == 0:
                reporter.broadcast(-loss, step=step)
    final = float(loss)
    if not math.isfinite(final):
        raise FloatingPointError("non-finite loss {}".format(final))
    return {"metric": -final, "final_loss": final}


def phase_slice_resnet(exp_dir):
    """The ResNet-50/CIFAR-10 ASHA sweep (BASELINE.md config 3), then the
    BatchNorm check (RESNET_BN_STEPS steps replayed against the same steps
    taken eagerly from the same start: the running statistics agree, so
    each replay updated them once), the trained model's eval logits on the
    card against the CPU's, the step alone (eager and replayed in turns)
    and a profile of five replayed steps."""
    from maggy_tpu_torch import Searchspace
    from maggy_tpu_torch.optimizers import Asha
    from maggy_tpu_torch.train import clear_warm, warm

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    sp = Searchspace(lr=("DOUBLE", [1e-4, 1e-2]), width=("DISCRETE", RESNET_WIDTHS),
                     weight_decay=("DOUBLE", [1e-5, 1e-3]))
    swept = record_sweep(
        "slice_resnet", exp_dir, train_resnet, name="resnet50_cifar_asha_smoke", num_trials=9,
        optimizer=Asha(reduction_factor=3, resource_min=1, resource_max=9, seed=0),
        searchspace=sp, num_workers=3, es_policy="median", es_min=3)
    launches = swept[-1]
    if any(launches.values()):
        raise AssertionError("slice_resnet launched attention kernels: {}".format(launches))
    peak_sweep = torch.cuda.max_memory_allocated()

    # The BatchNorm check and the eval logits, at ResNet-50's own width.
    # At lr 0 the weights stay put, so the running statistics of the
    # replayed steps must be the eager steps' up to the forward's rounding.
    # At lr 1e-3, with cuDNN's deterministic algorithms, the replayed run
    # must match the same warm trainer stepped eagerly (the captured step's
    # arithmetic: capturable AdamW, lr on a tensor). Two witnesses are
    # printed, not gated: the capturable against the plain AdamW path (both
    # eager, deterministic algorithms), and two identical plain eager runs
    # under the sweep's own cuDNN settings.
    full_fp32()
    width, wd = RESNET_WIDTHS[-1], 1e-4
    source = resnet_batches()
    batches = [next(source) for _ in range(RESNET_BN_STEPS)]

    def bn_run(lr, mode):
        """RESNET_BN_STEPS steps from the same start: "replayed" (the warm
        path: an eager warm-up step, then graphs), "warm_eager" (the warm
        path's trainer, its capturable optimizer, every step eager) or
        "plain" (warm_start=False). Returns (trainer, losses, replays)."""
        c0 = warm.counters()["graph_replays"]
        trainer = resnet_trainer(lr, width, wd, warm_start=mode != "plain")
        step = trainer._eager_step if mode == "warm_eager" else trainer.step
        losses = [step(b) for b in batches]
        torch.cuda.synchronize()
        return (trainer, [float(x) for x in losses],
                warm.counters()["graph_replays"] - c0)

    def bn_diff(a, b):
        errs = {name: float((x - y).abs().max()) / (1.0 + float(y.abs().max()))
                for (name, x), y in zip(a.model.named_buffers(), b.model.buffers())}
        worst = max(errs, key=errs.get)
        return {"max_rel_err": errs[worst], "worst": worst}

    replayed, r_losses, r_replays = bn_run(0.0, "replayed")
    eager0, e_losses, _ = bn_run(0.0, "plain")
    bn = {"lr": 0.0, "steps": RESNET_BN_STEPS, "replays": r_replays,
          "buffers": len(list(eager0.model.buffers())),
          "means_moved": sum(1 for name, ref in eager0.model.named_buffers()
                             if name.endswith("mean") and float(ref.abs().max()) > 0),
          **bn_diff(replayed, eager0), "rtol": RESNET_BN_RTOL,
          "losses_replayed": r_losses, "losses_eager": e_losses}
    del replayed
    cudnn = torch.backends.cudnn
    settings = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        replayed, r_losses, r_replays = bn_run(1e-3, "replayed")
        warm_eager, w_losses, _ = bn_run(1e-3, "warm_eager")
        plain, p_losses, _ = bn_run(1e-3, "plain")
    finally:
        cudnn.deterministic, cudnn.benchmark = settings
    bn_trained = {"lr": 1e-3, "steps": RESNET_BN_STEPS, "replays": r_replays,
                  "cudnn_deterministic": True, **bn_diff(replayed, warm_eager),
                  "rtol": RESNET_BN_RTOL, "losses_replayed": r_losses,
                  "losses_warm_eager": w_losses, "losses_plain": p_losses,
                  "witness_optimizer_paths": bn_diff(warm_eager, plain)}
    del warm_eager, plain
    plain_a, a_losses, _ = bn_run(1e-3, "plain")
    plain_b, b_losses, _ = bn_run(1e-3, "plain")
    bn_trained["witness_plain_twice"] = {
        "cudnn_deterministic": cudnn.deterministic, **bn_diff(plain_a, plain_b),
        "losses": [a_losses, b_losses]}
    del plain_a, plain_b
    # A warm hit: a unit that stepped and retired at trial end, re-initialized
    # in place for the next trial, whose steps replay the retired unit's
    # graph. A buffer that init_weights reassigned would leave the graph
    # updating the old tensor: the statistics would stay at 0 and 1.
    with warm.trial_scope("warm_hit_donor"):
        donor = resnet_trainer(1e-3, width, wd)
        for b in batches[:3]:
            donor.step(b)
    c0 = warm.counters()
    hit = resnet_trainer(0.0, width, wd)
    fresh = all(bool((buf == (0.0 if name.endswith("mean") else 1.0)).all())
                for name, buf in hit.model.named_buffers())
    for b in batches:
        hit.step(b)
    c1 = warm.counters()
    torch.cuda.synchronize()
    hit_err = bn_diff(hit, eager0)["max_rel_err"]
    bn["warm_hit"] = {"hits": c1["warm_hits"] - c0["warm_hits"], "fresh_buffers": fresh,
                      "replays": c1["graph_replays"] - c0["graph_replays"],
                      "max_rel_err": hit_err}
    del donor, hit, eager0
    if not (bn["replays"] == bn_trained["replays"] == RESNET_BN_STEPS - 1
            and bn["max_rel_err"] <= RESNET_BN_RTOL and bn["means_moved"] == bn["buffers"] // 2
            and bn_trained["max_rel_err"] <= RESNET_BN_RTOL
            and bn["warm_hit"] == {"hits": 1, "fresh_buffers": True,
                                   "replays": RESNET_BN_STEPS, "max_rel_err": hit_err}
            and hit_err <= RESNET_BN_RTOL):
        emit("slice_resnet", batch_norm=bn, batch_norm_trained=bn_trained)
        raise AssertionError("slice_resnet: replayed BatchNorm statistics off the eager "
                             "steps': {} {}".format(bn, bn_trained))
    small = batches[0]["inputs"][0][:8]
    with torch.no_grad():
        gpu_logits = replayed.model(small, train=False).cpu()
        cpu_logits = copy.deepcopy(replayed.model).to("cpu")(small.cpu(), train=False)
    logits = {"max_abs_err": float((gpu_logits - cpu_logits).abs().max()),
              "tol": RESNET_LOGIT_RTOL * float(cpu_logits.abs().max()) + 1e-5}
    if not (torch.isfinite(gpu_logits).all() and gpu_logits.shape == (8, 2)
            and logits["max_abs_err"] <= logits["tol"]):
        emit("slice_resnet", batch_norm=bn, eval_logits=logits)
        raise AssertionError("slice_resnet: eval logits off the CPU's: {}".format(logits))
    del replayed
    gc.collect()

    alone, graph_trainer = alone_step_ms(
        lambda ws: resnet_trainer(1e-3, width, wd, warm_start=ws),
        lambda i: batches[i % len(batches)], warmup=3, n=10)
    profile = step_device_profile(lambda i: graph_trainer.step(batches[i % len(batches)]))
    del graph_trainer
    clear_warm()
    emit("slice_resnet", depth=RESNET_DEPTH, widths=RESNET_WIDTHS, batch=RESNET_BATCH,
         **sweep_fields(*swept[:-1]), launches=launches,
         step_ms_alone=float(np.median(alone["graph"])),
         step_ms_alone_eager=float(np.median(alone["eager"])), step_ms_alone_pairs=alone,
         step_profile=profile, batch_norm=bn, batch_norm_trained=bn_trained,
         eval_logits=logits, tf32=tf32_settings(),
         peak_mem_sweep_gb=peak_sweep / 1e9,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
         phase_s=time.perf_counter() - t_phase)


def vit_config():
    from maggy_tpu_torch.models import ViTConfig

    return ViTConfig.base(num_classes=2)


def vit_batch(i):
    """Batch i (cycling) of examples/vit_cifar_hpo.py's seeded set at the
    configuration's image size: VIT_N images, label = positive mean."""
    def build():
        side = vit_config().image_size
        rng = np.random.default_rng(0)
        X = rng.normal(size=(VIT_N, side, side, 3)).astype(np.float32)
        y = (X.mean(axis=(1, 2, 3)) > 0).astype(np.int64)
        return torch.as_tensor(X, device=DEVICE), torch.as_tensor(y, device=DEVICE)

    X, y = cached("vit", build)
    lo = (i % (VIT_N // VIT_BATCH)) * VIT_BATCH
    return {"inputs": (X[lo:lo + VIT_BATCH],), "labels": y[lo:lo + VIT_BATCH]}


def vit_trainer(lr, warm_start=None):
    """The example's trainer: ViT with a plain adamw(lr) (each trial its
    own slot, as the example intends), eval-mode forward."""
    from maggy_tpu_torch.models import ViT
    from maggy_tpu_torch.train import Trainer, adamw

    return Trainer(ViT(vit_config(), device="meta"), adamw(float(lr)), labels_loss,
                   device=DEVICE, warm_start=warm_start).init(seed=0)


def train_vit(lr, reporter, out_dir):
    """One trial of slice_vit: examples/vit_cifar_hpo.py's train_fn."""
    record = TrialRecord(out_dir, reporter)
    full_fp32()
    trainer = vit_trainer(lr)
    with record:
        for i in range(VIT_STEPS):
            loss = trainer.step(vit_batch(i))
            record.steps += 1
            if i % VIT_REPORT_EVERY == 0:
                reporter.broadcast(-loss, step=i)
    final = float(loss)
    if not math.isfinite(final):
        raise FloatingPointError("non-finite loss {}".format(final))
    return {"metric": -final}


def phase_slice_vit(exp_dir):
    """The ViT TPE sweep at ViT-B/16 (197 tokens: the attention runs the
    reference path, so the flash launches must be 0), a two-layer model at
    full width against the CPU, the step alone and a profile."""
    from maggy_tpu_torch import Searchspace
    from maggy_tpu_torch.models import ViT
    from maggy_tpu_torch.train import clear_warm

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    swept = record_sweep(
        "slice_vit", exp_dir, train_vit, name="vit_b16_tpe_smoke", num_trials=VIT_TRIALS,
        optimizer="tpe", searchspace=Searchspace(lr=("DOUBLE_LOG", [1e-4, 1e-2])),
        num_workers=2, es_policy="none")
    launches = swept[-1]
    if any(launches.values()):
        raise AssertionError("slice_vit launched flash kernels: {}".format(launches))
    peak_sweep = torch.cuda.max_memory_allocated()

    cfg2 = dataclasses.replace(vit_config(), num_layers=2)
    model = ViT(cfg2, device=DEVICE)
    model.init_weights(torch.Generator(device=DEVICE).manual_seed(3))
    small = vit_batch(0)["inputs"][0][:2]
    with torch.no_grad():
        gpu_logits = model(small).cpu()
        cpu_logits = copy.deepcopy(model).to("cpu")(small.cpu())
    del model
    logits = {"max_abs_err": float((gpu_logits - cpu_logits).abs().max()),
              "tol": bf16_tolerance(cpu_logits)}
    if not (torch.isfinite(gpu_logits).all() and logits["max_abs_err"] <= logits["tol"]):
        emit("slice_vit", full_width_logits=logits)
        raise AssertionError("slice_vit: two-layer ViT-B logits off the CPU's: {}".format(
            logits))

    alone, graph_trainer = alone_step_ms(lambda ws: vit_trainer(1e-3, warm_start=ws), vit_batch,
                                         warmup=3, n=10)
    profile = step_device_profile(lambda i: graph_trainer.step(vit_batch(i)))
    del graph_trainer
    clear_warm()
    emit("slice_vit", config="ViT-B/16", image_size=cfg2.image_size, tokens=cfg2.num_patches + 1,
         batch=VIT_BATCH, **sweep_fields(*swept[:-1]), flash_launches=launches,
         step_ms_alone=float(np.median(alone["graph"])),
         step_ms_alone_eager=float(np.median(alone["eager"])), step_ms_alone_pairs=alone,
         step_profile=profile, full_width_logits=logits, tf32=tf32_settings(),
         peak_mem_sweep_gb=peak_sweep / 1e9,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
         phase_s=time.perf_counter() - t_phase)


def moe_config(lora_rank=16, lora_alpha=16.0):
    from maggy_tpu_torch.models import LlamaConfig

    return dataclasses.replace(
        LlamaConfig.llama3_8b(lora_rank=int(lora_rank)), lora_alpha=float(lora_alpha),
        num_layers=MOE_LAYERS, num_experts=MOE_EXPERTS, moe_top_k=MOE_TOP_K,
        moe_capacity_factor=MOE_CAPACITY_FACTOR)


def phase_slice_moe(exp_dir):
    """slice_llama's LoRA sweep with MOE_EXPERTS experts a layer. The depth
    is cut by a memory reckoning: a layer holds 1.41 B expert parameters
    (8 x 3 x 4096 x 14336) beside 42 M of attention, so 4 layers and the
    2.1 GB embedding and head are 13.7 GB frozen in bf16, but 27 GB while a
    trial initializes in fp32 before only_lora casts the base, and two
    runners may initialize at once. Checked: launches exact (the forward
    twice a layer and step under remat), every step replayed after its
    warm-up, each step's objective less its task loss equal to its summed
    aux loss. Printed: the aux loss per step, the share of routed tokens
    dropped at capacity (one forward of the alone trainer's model), the
    step alone, eager and replayed, and peak memory."""
    from maggy_tpu_torch.models import Llama
    from maggy_tpu_torch.models.moe import _top_k_mask, routing_tensors
    from maggy_tpu_torch.ops import chunked_next_token_loss
    from maggy_tpu_torch.train import Trainer, adamw, clear_warm, only_lora

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = moe_config()
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(4, LLAMA_B, LLAMA_S)), device=DEVICE)

    def batch(i):
        t = tokens[i % tokens.shape[0]]
        return {"inputs": (t,), "tokens": t}

    def make_trainer(lora_rank, lora_alpha, lr, warm_start=None):
        """A trainer, and per step its (objective, task loss, summed aux
        loss): the loss function keeps its last task loss (under capture
        the graph's tensor, which each replay rewrites)."""
        box = {}

        def loss_fn(out, b):
            task = chunked_next_token_loss(out[0], out[1], b["tokens"])
            box["task"] = task.detach()
            return task

        trainer = Trainer(Llama(moe_config(lora_rank, lora_alpha), device="meta"),
                          only_lora(adamw(lr)), loss_fn, device=DEVICE,
                          train_kwargs={"return_hidden": True}, warm_start=warm_start)
        return trainer.init(seed=0), lambda loss: (loss, box["task"].clone(), trainer.aux_loss)

    sweep = llama_lora_sweep("slice_moe", "llama3_8b_moe_lora_asha_smoke", exp_dir,
                             make_trainer, batch, cfg.num_layers)
    reading = warm_reading("slice_moe", sweep["telemetry"], sweep["before"])
    replayed_after_warmup("slice_moe", reading, sweep["steps"])
    CAPTURED["llama3_8b_moe"] = reading["captured"]
    # objective = task + each layer's aux loss, in fp32 (a few roundings of
    # a loss near ln(vocab) = 11.8).
    rows = sweep["rows"]
    aux_gap = max(abs(obj - task - aux) for obj, task, aux in rows)
    if not (len(rows) == sweep["steps"] and aux_gap <= 1e-5
            and all(math.isfinite(a) and a > 0 for _, _, a in rows)):
        emit("slice_moe", aux_rows=rows)
        raise AssertionError("slice_moe: objective less task loss off the summed aux loss "
                             "by {}".format(aux_gap))
    gc.collect()
    torch.cuda.empty_cache()

    alone, graph_trainer = alone_step_ms(
        lambda ws: make_trainer(16, 16.0, 1e-4, warm_start=ws)[0], batch, warmup=2, n=3,
        pairs=1)
    alone_graph_ok = graph_trainer._slot.graph_ok
    routed = []

    def count_routing(mod, args):
        x = args[0]
        top_k = min(mod.top_k, mod.num_experts)
        logits = x.float() @ mod.router.float()
        dispatch, _, _ = routing_tensors(logits, mod.num_experts, mod.capacity(x.shape[1]), top_k)
        routed.append((float(dispatch.sum()),
                       float(_top_k_mask(torch.softmax(logits, -1), top_k).sum())))

    hooks = [layer.moe_mlp.register_forward_pre_hook(count_routing)
             for layer in graph_trainer.model.layers]
    with torch.no_grad():
        graph_trainer.model(batch(0)["inputs"][0], return_hidden=True)
    for h in hooks:
        h.remove()
    del graph_trainer
    clear_warm()
    kept, total = sum(k for k, _ in routed), sum(r for _, r in routed)
    result = sweep["result"]
    emit("slice_moe", layers=cfg.num_layers, experts=cfg.num_experts, top_k=cfg.moe_top_k,
         capacity_factor=cfg.moe_capacity_factor,
         capacity=int(cfg.moe_capacity_factor * LLAMA_S * cfg.moe_top_k / cfg.num_experts),
         trials_finished=sweep["trials_finished"],
         promoted=sweep["promoted"], best_hp=result["best_hp"], best_val=result["best_val"],
         steps=sweep["steps"], launches=sweep["launches"], expected_launches=sweep["expected"],
         sweep_wall_s=sweep["wall"], step_ms_in_sweep_median=float(np.median(sweep["step_ms"])),
         aux_loss_per_step=[a for _, _, a in rows],
         objective_less_task_minus_aux_max_abs=aux_gap,
         dropped_share=1.0 - kept / total, routed_per_layer=routed,
         step_ms_alone=alone["graph"][0], step_ms_alone_eager=alone["eager"][0],
         alone_graph_ok=alone_graph_ok, warm=reading,
         pipeline=pipeline_summary(result["pipeline"]), telemetry=public(sweep["telemetry"]),
         peak_mem_sweep_gb=sweep["peak_sweep"] / 1e9,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
         phase_s=time.perf_counter() - t_phase)
    return sweep["launches"]


# ----------------------------------------- slice 13: chaos, health and obs


#: slice_chaos: where its soaks run (outside the earlier phases' dirs, which
#: its journal audit reads), the trials' heartbeat, the MNIST trial's budget
#: (40 steps a unit), the checkpointing trial's steps a unit and its pause a
#: step (its preemption lands mid-trial), the stall and the stall soak's hang
#: factor (those of the JAX package's --stall soak: a 2 s stall, factor 10,
#: so a 1 s bound at this heartbeat), its trials (the sweep must outlive the stall's flags), and the phases
#: whose sweeps inject faults on purpose.
CHAOS_ROOT = os.path.join(ROOT, "build", "chip_smoke_chaos")
CHAOS_HB_S, CHAOS_BUDGET = 0.1, 6
CHAOS_CKPT_STEPS, CHAOS_CKPT_PACE_S = 16, 0.02
CHAOS_STALL_S, CHAOS_STALL_TRIALS, CHAOS_HANG_FACTOR = 2.0, 20, 10.0
#: A sub-soak still running after this many seconds dumps every thread's
#: stack and ends the script (faulthandler), instead of holding the card.
CHAOS_SOAK_LIMIT_S = 240
FAULTED_PHASES = ("chip_smoke_experiments_recovery", "chip_smoke_experiments_resume",
                  "chip_smoke_experiments_pbt")


def chaos_space():
    from maggy_tpu_torch import Searchspace

    return Searchspace(lr=("DOUBLE_LOG", [1e-4, 3e-2]), batch=("DISCRETE", MNIST_BATCHES))


def mnist_ckpt_state(trainer, steps_done, loss=0.0):
    return {"model": trainer.model.state_dict(), "optimizer": trainer.optimizer.state_dict(),
            "steps_done": steps_done, "loss": float(loss)}


def train_mnist_ckpt(lr, reporter, ctx, out_dir, budget=1, batch=MNIST_BATCHES[0]):
    """slice_chaos's checkpointing trial: train_mnist's model, data and
    swept optimizer for CHAOS_CKPT_STEPS steps a budget unit, each step
    checkpointed through the TrialContext before its heartbeat, then a
    pause of CHAOS_CKPT_PACE_S; with ``ctx.resume_step`` (a preemption's
    acked step or a fork's staged one) it restores the trial's newest
    checkpoint and goes on at the step after it: the staged step, or a later
    one that a killed attempt saved before its FINAL was lost (one that
    finished its steps trains no more)."""
    from maggy_tpu_torch.train import ShardedBatchIterator, Trainer, adam, swept_transform

    record = TrialRecord(out_dir, reporter)
    full_fp32()
    X, Y = cached("mnist", make_data)
    trainer = Trainer(mnist_model("meta"), swept_transform(adam, learning_rate=lr), labels_loss,
                      device=DEVICE).init(seed=0)
    steps = CHAOS_CKPT_STEPS * int(budget)
    if ctx.resume_step is not None:
        state = ctx.restore_checkpoint(mnist_ckpt_state(trainer, 0))
        if state is None or not ctx.resume_step + 1 <= state["steps_done"] <= steps:
            raise RuntimeError("trial {} resumes at step {} but its checkpoint holds {}".format(
                reporter.trial_id, ctx.resume_step, state and state["steps_done"]))
        trainer.model.load_state_dict(state["model"])
        trainer.optimizer.load_state_dict(state["optimizer"])
        record.first_step = state["steps_done"]
        loss = state["loss"]
    else:
        loss = None
    it = iter(ShardedBatchIterator({"x": X, "y": Y}, batch_size=int(batch), epochs=None,
                                   seed=1, device=DEVICE))
    with record:
        for i in range(record.first_step, steps):
            b = next(it)
            loss = trainer.step({"inputs": (b["x"],), "labels": b["y"]})
            record.steps += 1
            ctx.save_checkpoint(i, mnist_ckpt_state(trainer, i + 1, loss))
            reporter.broadcast(-loss, step=i)
            time.sleep(CHAOS_CKPT_PACE_S)
    return {"metric": -float(loss)}


def chaos_events(report, ev):
    from maggy_tpu_torch.telemetry import read_events

    return [e for e in read_events(report["journal"]) if e["ev"] == ev]


def replacement_first_metric_s(report):
    """Per runner-death fault: fault to its trial's requeue, to the re-run's
    dispatch (its running edge) and to the re-run's first metric (the first
    heartbeat of the trial's re-run: the driver journals a second
    first_metric edge only for steps the dead run had not reported), s,
    from the journal."""
    from maggy_tpu_torch.telemetry import read_events

    events = read_events(report["journal"])
    out = []
    for c in (e for e in events if e["ev"] == "chaos" and e.get("trial")
              and e["kind"] in ("kill_runner", "kill_fork", "fake_preemption")):
        later = [e for e in events if e.get("trial") == c["trial"] and e["t"] >= c["t"]]
        req = next((e["t"] for e in later if e.get("phase") == "requeued"), None)
        rerun = [e for e in later if req is not None and e["t"] >= req]
        run = next((e["t"] for e in rerun if e.get("phase") == "running"), None)
        beat = next((e["t"] for e in rerun if e["ev"] == "runner_stats" and "steps" in e
                     and run is not None and e["t"] >= run), None)
        out.append({"kind": c["kind"], "mechanism": c.get("mechanism"),
                    "partition": c.get("partition"),
                    **{"fault_to_{}_s".format(k): None if t is None else t - c["t"]
                       for k, t in (("requeue", req), ("rerun_dispatch", run),
                                    ("rerun_first_metric", beat))}})
    return out


def trace_categories(path):
    """Events by category in a torch.profiler Chrome trace ("kernel": CUDA
    kernels; "cuda_runtime": the host's CUDA calls that CUPTI saw)."""
    with open(path) as f:
        return dict(collections.Counter(e.get("cat") for e in json.load(f).get("traceEvents", [])))


def stall_reading(report, problems):
    """slice_chaos's stall sub-soak: the one auto capture (its dump, trace,
    CUDA kernel events, time and size) and /healthz across the stall."""
    captures = [e for e in chaos_events(report, "profile_captured") if e.get("reason") == "auto"]
    stall = chaos_events(report, "chaos")[0]
    out = {"captures": len(captures),
           "profiler_primed_s": chaos_events(report, "obs_started")[0]["profiler_primed_s"],
           "flags": [{k: e.get(k) for k in ("check", "metric", "partition", "silent_s",
                                            "value_ms")} | {"at_s": e["t"] - stall["t"]}
                     for e in chaos_events(report, "health") if e.get("status") == "raised"]}
    if len(captures) != 1:
        problems.append("stall: {} auto profile captures, not 1".format(len(captures)))
    else:
        cap = captures[0]
        trace = os.path.join(cap["path"], "trace.json")
        files = sorted(os.listdir(cap["path"]))
        out.update(files=files, activities=cap.get("activities"), check=cap.get("check"),
                   partition=cap.get("partition"), window_s=cap.get("duration_s"))
        if files != ["threads.txt", "trace.json"]:
            problems.append("stall: the capture holds {}".format(files))
        else:
            cats = trace_categories(trace)
            out.update(kernel_events=cats.get("kernel", 0), trace_categories=cats,
                       trace_bytes=os.path.getsize(trace),
                       journaled_to_trace_written_s=os.path.getmtime(trace) - cap["t"])
            if not out["kernel_events"]:
                problems.append("stall: the capture's trace holds no CUDA kernel event "
                                "(events by category {})".format(cats))
    codes = [(t, c) for t, c in report["obs"]["healthz"] if t >= stall["t"]]
    first_503 = next((t for t, c in codes if c == 503), None)
    after = [t for t, c in codes if c == 200 and first_503 is not None and t > first_503]
    out.update(healthz_503_at_s=None if first_503 is None else first_503 - stall["t"],
               healthz_200_again_at_s=after[0] - stall["t"] if after else None,
               scrapes=report["obs"]["scrapes"], scrape_ms=report["obs"]["scrape_ms"])
    if first_503 is None or not after:
        problems.append("stall: /healthz did not read 503 during the stall and 200 after it")
    return out


def allocated_after_release():
    """Allocated bytes after dropping every warm unit (clear_warm), then
    after also dropping the cuBLAS workspaces PyTorch keeps for each
    (handle, stream) pair, one pair for each capture's side stream."""
    from maggy_tpu_torch.train import clear_warm

    clear_warm()
    gc.collect()
    torch.cuda.empty_cache()
    cleared = torch.cuda.memory_allocated()
    torch._C._cuda_clearCublasWorkspaces()
    return [cleared, torch.cuda.memory_allocated()]


def witness_line(block):
    """A soak's lock-order witness reading as a phase line prints it: the
    edges seen, the forbidden ones, the acquisitions the witness noted and
    the seconds it spent noting them (its overhead, less the wrapper's own
    call cost); None for a soak that ran without it."""
    if block is None:
        return None
    return {"edges_seen": block.get("edge_count", block.get("edges")),
            "violations": block["violations"], "acquisitions": block["acquisitions"],
            "overhead_s": block["busy_s"]}


def chaos_soak(name, run, problems, kinds, pool="thread"):
    """Run one slice_chaos sub-soak and print its line: violations,
    injections by kind, recovery latencies, health flags, wall, warm
    counters, warm units and allocated bytes before and after (and after
    the units and the cuBLAS workspaces are dropped), peak memory, and the
    lock-order witness's reading (every soak runs under it). A violation (a
    forbidden lock-order edge among them), a soak without the witness, or no
    injection of each kind in ``kinds``, is a problem."""
    from maggy_tpu_torch.train import warm

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before, units0, alloc0 = warm.counters(), warm.warm_cache().retired_units(), \
        torch.cuda.memory_allocated()
    faulthandler.dump_traceback_later(CHAOS_SOAK_LIMIT_S, exit=True)
    try:
        report = run()
    finally:
        faulthandler.cancel_dump_traceback_later()
    gc.collect()
    line = {"violations": report["violations"], "injected": report["faults"]["by_kind"],
            "recoveries": report["recoveries"], "preemptions": report["preemptions"],
            "forks": report["forks"], "vmap_blocks": report["vmap_blocks"],
            "health": {k: report["health"][k] for k in ("raised", "by_check", "stall_flags")},
            "trials": report["trials"], "lost_runners": report["result"]["lost_runners"],
            "client_retries": report["client_retries"], "wall_s": report["wall_s"],
            "warm": {k: v - before[k] for k, v in warm.counters().items()} if pool == "thread"
            else journal_counters(chaos_events(report, "runner_stats")),
            "graph_errors": [e.get("graph_error") for e in chaos_events(report, "trial")
                             if e["phase"] == "compiled" and e.get("graph_ok") is False],
            "warm_units": [units0, warm.warm_cache().retired_units()],
            "allocated_bytes": [alloc0, torch.cuda.memory_allocated()],
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "faults": replacement_first_metric_s(report)}
    line["allocated_bytes_released"] = allocated_after_release()
    line["witness"] = witness_line(report.get("witness"))
    if line["witness"] is None:
        problems.append("{}: ran without the lock-order witness".format(name))
    for kind in kinds:
        if not report["faults"]["by_kind"].get(kind):
            problems.append("{}: no {} injected".format(name, kind))
    if report["violations"]:
        problems.append("{}: {}".format(name, report["violations"]))
    return report, line


def journal_audit(problems):
    """check_invariants over every earlier phase's journal: invariants 1
    (no lost or phantom trial), 2 (no duplicate FINAL) and 4 (the experiment
    ended) on each, and each journal's raised health flags by check."""
    from maggy_tpu_torch.chaos.harness import check_invariants
    from maggy_tpu_torch.telemetry import read_events

    audit = {}
    for path in sorted(glob.glob(os.path.join(ROOT, "build", "chip_smoke_experiments*", "**",
                                              "telemetry.jsonl"), recursive=True)):
        rel = os.path.relpath(os.path.dirname(path), os.path.join(ROOT, "build"))
        events = read_events(path)
        report = check_invariants(events)
        held = [v for v in report["violations"]
                if v.startswith(("lost trial", "phantom trial", "duplicate FINAL",
                                 "experiment never finalized"))]
        audit[rel] = {"trials": report["trials"]["finalized"],
                      "raised": report["health"]["raised"],
                      "by_check": report["health"]["by_check"],
                      "flags": [{k: e.get(k) for k in ("check", "metric", "partition", "window",
                                                       "silent_s", "bound_s", "value_ms",
                                                       "fleet_median_ms")}
                                for e in events
                                if e["ev"] == "health" and e.get("status") == "raised"],
                      "fault_free": not rel.startswith(FAULTED_PHASES),
                      "invariants_1_2_4": held}
        if held:
            problems.append("journal {}: {}".format(rel, held))
    if not audit:
        problems.append("no earlier phase's journal to audit")
    flagged = {k: v["by_check"] for k, v in audit.items() if v["fault_free"] and v["raised"]}
    return audit, flagged


def phase_slice_chaos():
    """The port's chaos soaks on the card through maggy_tpu_torch.chaos's
    harness, with trials that train on it, then the journal audit."""
    from maggy_tpu_torch.chaos import harness
    from maggy_tpu_torch.train import clear_warm

    t_phase = time.perf_counter()
    # The earlier phases' objects live to the end of the script: moved out
    # of the collector's reach, an automatic full collection during a soak
    # (which holds every runner thread) walks only the soaks' objects.
    gc.collect()
    gc.freeze()
    fresh_dir(CHAOS_ROOT)
    out_dir = fresh_dir(os.path.join(CHAOS_ROOT, "records"))
    problems = []
    mnist = functools.partial(train_mnist, out_dir=out_dir, budget=CHAOS_BUDGET)
    ckpt = functools.partial(train_mnist_ckpt, out_dir=out_dir)
    space = {"searchspace": chaos_space()}

    def soak(name, **kw):
        return lambda: harness.run_soak(base_dir=os.path.join(CHAOS_ROOT, name),
                                        hb_interval=CHAOS_HB_S, lock_witness=True, **kw)

    subsoaks = [
        ("kill_thread", ["kill_runner", "fake_preemption"], "thread",
         soak("kill_thread", plan=harness.default_plan(7), seed=7, train_fn=mnist,
              hb_loss_timeout=1.0, config_overrides=space)),
        ("kill_process", ["kill_runner"], "process",
         soak("kill_process", plan=harness.default_plan(7), seed=7, train_fn=mnist,
              num_trials=6, workers=2, pool="process", hb_loss_timeout=RECOVERY_LOSS_TIMEOUT_S,
              config_overrides=space)),
        ("piggyback", ["kill_runner"], "thread",
         soak("piggyback", plan=harness.piggyback_plan(7), seed=7, train_fn=mnist,
              hb_loss_timeout=1.0, config_overrides=space)),
        ("stall_obs", ["stall_runner"], "thread",
         soak("stall_obs", plan=harness.stall_plan(7, duration_s=CHAOS_STALL_S), seed=7,
              train_fn=mnist, num_trials=CHAOS_STALL_TRIALS, hb_loss_timeout=10.0, obs=True,
              config_overrides={**space, "health_hang_factor": CHAOS_HANG_FACTOR,
                                "health_interval_s": 0.1})),
        ("preempt", ["preempt_trial"], "thread",
         soak("preempt", plan=harness.preempt_plan(7), seed=7, train_fn=ckpt,
              hb_loss_timeout=1.0, config_overrides=space)),
        ("fork", ["kill_fork"], "thread",
         lambda: harness.run_fork_soak(seed=7, base_dir=os.path.join(CHAOS_ROOT, "fork"),
                                       train_fn=ckpt, hb_interval=CHAOS_HB_S,
                                       hb_loss_timeout=1.0, lock_witness=True)),
        ("lanes", ["kill_runner"], "thread",
         lambda: harness.run_vmap_soak(
             seed=7, base_dir=os.path.join(CHAOS_ROOT, "lanes"), hb_interval=CHAOS_HB_S,
             hb_loss_timeout=1.0, lock_witness=True,
             train_fn=functools.partial(train_mnist_vmap, out_dir=out_dir))),
        ("control", [], "thread",
         lambda: harness.run_goodput_soak(seed=7, base_dir=os.path.join(CHAOS_ROOT, "control"),
                                          hb_interval=CHAOS_HB_S, train_fn=mnist,
                                          config_overrides=space, lock_witness=True)),
    ]
    lines = {}
    for name, kinds, pool, run in subsoaks:
        clear_warm()
        report, line = chaos_soak(name, run, problems, kinds, pool)
        if name == "stall_obs":
            line["stall"] = stall_reading(report, problems)
        elif name == "piggyback" and [r.get("requeues") for r in report["recoveries"]] != [1]:
            problems.append("piggyback: requeues {}".format(report["recoveries"]))
        elif name == "preempt" and not [p for p in report["preemptions"]
                                        if p.get("outcome") == "preempted"
                                        and p.get("from_step", 0) >= 1]:
            problems.append("preempt: no trial preempted and resumed from its checkpoint")
        elif name == "fork":
            line["fork_failover"] = {k: report["fork_failover"][k] for k in ("violations",
                                                                             "fork")}
            if not [f for f in report["forks"] if f.get("outcome") == "resumed_from_fork"]:
                problems.append("fork: the killed fork did not resume from its fork point")
        elif name == "kill_process" and [f["mechanism"] for f in line["faults"]
                                         if f["kind"] == "kill_runner"] != ["sigkill"]:
            problems.append("kill_process: the kill was no SIGKILL: {}".format(line["faults"]))
        elif name == "control" and report["health"]["raised"]:
            problems.append("control: {} health flags in a fault-free soak".format(
                report["health"]["raised"]))
        emit("slice_chaos/" + name, **line)
        lines[name] = line
    clear_warm()
    gc.unfreeze()
    audit, flagged = journal_audit(problems)
    emit("slice_chaos/journals", journals=audit, fault_free_flagged=flagged)
    emit("slice_chaos", soaks=sorted(lines), phase_s=time.perf_counter() - t_phase,
         problems=problems)
    if problems:
        raise AssertionError("slice_chaos: {}".format("; ".join(map(str, problems))))


# ------------------------------------------------- slice 14: ablation studies


def make_titanic_like(n=TITANIC_N, seed=0):
    """examples/titanic_ablation.py's data: five standard-normal features;
    survived = [1.5 sex - 0.8 pclass + 0.3 fare + noise > 0]."""
    rng = np.random.default_rng(seed)
    X = {f: rng.normal(size=n).astype(np.float32) for f in TITANIC_FEATURES}
    logits = 1.5 * X["sex"] - 0.8 * X["pclass"] + 0.3 * X["fare"]
    y = (logits + 0.5 * rng.normal(size=n) > 0).astype(np.int32)
    return X, y


def titanic_input():
    """Flax's nn.Dense(32) infers its input width; the port's input layer is
    lazy, since an ablated feature leaves four."""
    return torch.nn.LazyLinear(32)


def titanic_hidden():
    return torch.nn.Sequential(torch.nn.Linear(32, 32), torch.nn.ReLU())


def titanic_head():
    return torch.nn.Linear(32, 2)


TITANIC_LAYERS = (("input_dense", titanic_input), ("hidden_1", titanic_hidden),
                  ("hidden_2", titanic_hidden), ("head", titanic_head))


def titanic_model(ablated_layers=frozenset()):
    from maggy_tpu_torch.models.surgery import ablatable_model_generator

    return ablatable_model_generator(TITANIC_LAYERS, ablated_layers)


def titanic_params(ablated_feature, ablated_layer):
    """The parameter count of a titanic trial's model: its kept layers'."""
    from maggy_tpu_torch.models.surgery import filter_layers

    features = len(TITANIC_FEATURES) - (ablated_feature != "None")
    ablated = frozenset() if ablated_layer == "None" else frozenset(
        [ablated_layer] if isinstance(ablated_layer, str) else ablated_layer)
    sizes = {"input_dense": 32 * features + 32, "hidden_1": 32 * 32 + 32,
             "hidden_2": 32 * 32 + 32, "head": 32 * 2 + 2}
    return sum(sizes[n] for n in filter_layers([n for n, _ in TITANIC_LAYERS], ablated))


def train_titanic(dataset_function, model_function, ablated_feature, ablated_layer, reporter,
                  out_dir):
    """examples/titanic_ablation.py's train_fn through the port's Trainer
    on the card: the registry's TFRecord minus the ablated feature, the
    model minus the ablated layers, full batch, Adam, TITANIC_STEPS steps."""
    from maggy_tpu_torch.train import Trainer, adam

    record = TrialRecord(out_dir, reporter)
    data = dataset_function()
    y = torch.as_tensor(np.asarray(data.pop("survived"), dtype=np.int64), device=DEVICE)
    x = torch.as_tensor(np.stack([data[c] for c in sorted(data)], axis=1), device=DEVICE)
    batch = {"inputs": (x,), "labels": y}
    trainer = Trainer(model_function(), adam(TITANIC_LR), labels_loss, device=DEVICE).init(
        seed=0, example_inputs=batch["inputs"])
    with record:
        for i in range(TITANIC_STEPS):
            loss = trainer.step(batch)
            record.steps += 1
            if i % 20 == 0:
                reporter.broadcast(-loss, step=i)
    with torch.no_grad():
        acc = float((trainer.model(x).argmax(-1) == y).float().mean())
    return {"metric": acc, "loss": float(loss),
            "params": sum(p.numel() for p in trainer.model.parameters())}


def bert_loco_dataset(ablated_feature=None):
    return bert_data()[1]


def bert_loco_model(ablated_layers=frozenset()):
    """BERT-base less the encoder layers filter_layers removes from
    [embed, layer_0 ... layer_11, head]: layers trained from scratch are
    interchangeable, so any n removed is the (12 - n)-layer encoder."""
    from maggy_tpu_torch.models import BertEncoder
    from maggy_tpu_torch.models.surgery import filter_layers

    cfg = bert_data()[0]
    removed = len(BERT_LOCO_NAMES) - len(filter_layers(BERT_LOCO_NAMES, frozenset(ablated_layers)))
    return BertEncoder(dataclasses.replace(cfg, num_layers=cfg.num_layers - removed),
                       device="meta")


def train_bert_loco(dataset_function, model_function, ablated_feature, ablated_layer, reporter,
                    out_dir):
    """A bert_base_loco trial: the ablated encoder on slice's batches under
    swept_transform(adamw, learning_rate=BERT_LOCO_LR), BERT_LOCO_STEPS
    steps, a heartbeat every REPORT_EVERY."""
    from maggy_tpu_torch.train import Trainer, adamw, swept_transform

    record = TrialRecord(out_dir, reporter)
    full_fp32()
    batch, model = dataset_function(), model_function()
    trainer = Trainer(model, swept_transform(adamw, learning_rate=BERT_LOCO_LR), labels_loss,
                      device=DEVICE).init(seed=0)
    with record:
        for i in range(BERT_LOCO_STEPS):
            loss = trainer.step(batch(i))
            record.steps += 1
            if i % REPORT_EVERY == REPORT_EVERY - 1:
                reporter.broadcast(-loss, step=i)
    return {"metric": -float(loss), "layers": model.cfg.num_layers}


def ablation_sweep(name, exp_dir, train, study, workers):
    """lagom(train, AblationConfig(study)) on ``workers`` thread runners:
    the journal checked, every step after a unit's warm-up replayed, and
    the LOCO schedule's trial ids finalized. Returns (line, trials, the
    flash launches)."""
    from maggy_tpu_torch import AblationConfig, experiment
    from maggy_tpu_torch.ablation.ablator import LOCO
    from maggy_tpu_torch.ops import attention as A
    from maggy_tpu_torch.train import clear_warm, warm

    exp = fresh_dir(os.path.join(exp_dir, "exp"))
    out_dir = fresh_dir(os.path.join(exp_dir, "records"))
    loco = LOCO(study)
    loco.initialize()
    scheduled = [t.trial_id for t in loco.trial_buffer]
    clear_warm()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = warm.counters()
    A.reset_launch_counts()
    t0 = time.perf_counter()
    result = experiment.lagom(functools.partial(train, out_dir=out_dir), AblationConfig(
        name=name, ablation_study=study, direction="max", num_workers=workers,
        hb_interval=0.1, experiment_dir=exp))
    wall = time.perf_counter() - t0
    launches = A.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    telemetry = journal_check("slice_ablation/" + name, exp, result)
    reading = warm_reading("slice_ablation/" + name, telemetry, before)
    clear_warm()
    records, trials = read_records(out_dir), read_trials(exp)
    steps = sum(r["steps"] for r in records)
    replayed_after_warmup("slice_ablation/" + name, reading, steps)
    if not (sorted(t["id"] for t in trials) == sorted(scheduled)
            and all(t["status"] == "FINALIZED" for t in trials)
            and result["num_trials"] == len(scheduled) == len(records)):
        raise AssertionError("slice_ablation/{}: {} trials finalized of the schedule's {}: "
                             "{}".format(name, len(trials), len(scheduled), result))
    comp = telemetry["_compile"]
    line = {"trials": len(trials), "steps": steps, "wall_s": wall,
            "step_ms_in_sweep_p50": float(np.median([r["step_ms"] for r in records])),
            "best_hp": result["best_hp"], "best_val": result["best_val"],
            "worst_hp": result["worst_hp"], "worst_val": result["worst_val"],
            "warm_hits": comp.get("warm_hits", 0), "warm_misses": comp.get("warm_misses", 0),
            "warm": reading, "goodput_s": telemetry["goodput"]["buckets_s"],
            "goodput_shares": telemetry["goodput"]["shares"], "peak_mem_gb": peak,
            "telemetry": public(telemetry)}
    return line, trials, launches


def phase_slice_ablation(exp_root):
    """Phase 19: two LOCO studies through lagom(AblationConfig) on thread
    runners. titanic_loco: examples/titanic_ablation.py's study, its data
    written as a TFRecord and registered as "titanic" in a DatasetRegistry
    rooted in the phase's directory, addressed by name and version: all 5
    features, layers hidden_1 and hidden_2 and the prefix group hidden, 9
    trials. bert_base_loco: BERT-base's 12 encoder layers singly, the group
    [layer_10, layer_11] and the prefix group layer_1, 15 trials, on
    slice's data. Returns bert_base_loco's flash launches."""
    from maggy_tpu_torch.ablation import AblationStudy
    from maggy_tpu_torch.train import DatasetRegistry
    from maggy_tpu_torch.train.tfrecord import write_tfrecord

    t_phase = time.perf_counter()
    problems = []
    exp_root = fresh_dir(exp_root)

    X, y = make_titanic_like()
    path = os.path.join(exp_root, "titanic.tfrecord")
    write_tfrecord(path, ({**{f: float(X[f][i]) for f in TITANIC_FEATURES},
                           "survived": int(y[i])} for i in range(len(y))))
    version = DatasetRegistry(root=os.path.join(exp_root, "registry")).register(
        "titanic", path, description="examples/titanic_ablation.py's make_titanic_like")
    os.environ["MAGGY_TPU_REGISTRY_ROOT"] = os.path.join(exp_root, "registry")
    study = AblationStudy("titanic", version, "survived")
    study.features.include(*TITANIC_FEATURES)
    study.model.set_base_model_generator(titanic_model)
    study.model.layers.include("hidden_1", "hidden_2")
    study.model.layers.include_groups(prefix="hidden")
    titanic, trials, _ = ablation_sweep("titanic_loco", os.path.join(exp_root, "titanic"),
                                        train_titanic, study, TITANIC_RUNNERS)
    wrong = {}
    for t in trials:
        want = titanic_params(t["params"]["ablated_feature"], t["params"]["ablated_layer"])
        got = read_output(exp_root, "titanic", t)
        if got != want:
            wrong[t["id"]] = [got, want]
    base = [t["final_metric"] for t in trials if t["params"]["ablated_feature"] == "None"
            and t["params"]["ablated_layer"] == "None"]
    titanic.update(base_accuracy=base[0] if base else None, params_off=wrong)
    if wrong:
        problems.append("titanic trials' parameter counts off their kept layers: {}".format(wrong))
    if titanic["worst_hp"]["ablated_feature"] != "sex":
        problems.append("titanic's worst ablation is {}, not sex".format(titanic["worst_hp"]))
    if not (base and base[0] > 0.8):
        problems.append("titanic's base accuracy {} <= 0.8".format(base))
    emit("slice_ablation/titanic_loco", **titanic)

    bert = AblationStudy("bert_glue", 1, "labels", dataset_generator=bert_loco_dataset)
    bert.model.set_base_model_generator(bert_loco_model)
    bert.model.layers.include(*BERT_LOCO_NAMES[1:-1])
    bert.model.layers.include_groups(["layer_10", "layer_11"])
    bert.model.layers.include_groups(prefix="layer_1")
    line, trials, launches = ablation_sweep("bert_base_loco", os.path.join(exp_root, "bert"),
                                            train_bert_loco, bert, BERT_LOCO_RUNNERS)
    CAPTURED["bert_base_loco"] = line["warm"]["captured"]
    # filter_layers matches every entry by name or prefix (both packages),
    # and a single layer reaches the generator as the same frozenset as a
    # prefix group of that name: the single "layer_1" trial drops layer_1,
    # layer_10 and layer_11, as the prefix group does. So 12, 11 x 11, 9,
    # 10 and 9 layers: (12 + 121 + 9 + 10 + 9) x 24 = 3864 launches.
    layers = sorted(read_output(exp_root, "bert", t) for t in trials)
    want = sorted([12] + [11] * 11 + [9, 10, 9])
    expected = sum(want) * BERT_LOCO_STEPS
    # Warm hits: one miss at most a runner and program (12, 11, 10 and 9
    # layers), the rest hits.
    programs = {n: want.count(n) for n in set(want)}
    min_hits = len(want) - sum(min(c, BERT_LOCO_RUNNERS) for c in programs.values())
    line.update(layers_per_trial=layers, launches=launches, expected_launches=expected,
                min_warm_hits=min_hits)
    if layers != want:
        problems.append("bert_base_loco trained {} layers a trial, want {}".format(layers, want))
    if any(n != expected for n in launches.values()) or set(launches) != set(REPLACES):
        problems.append("bert_base_loco launched {}, want {} each".format(launches, expected))
    if line["warm_hits"] < min_hits:
        problems.append("bert_base_loco: {} warm hits, want >= {} (one miss a runner and "
                        "program)".format(line["warm_hits"], min_hits))
    emit("slice_ablation/bert_base_loco", **line)
    emit("slice_ablation", phase_s=time.perf_counter() - t_phase, problems=problems)
    if problems:
        raise AssertionError("slice_ablation: {}".format("; ".join(problems)))
    return launches


def read_output(exp_root, study, trial):
    """A trial's returned "params" (titanic) or "layers" (bert) from its
    .outputs.json."""
    (path,) = glob.glob(os.path.join(exp_root, study, "exp", "*", trial["id"],
                                     ".outputs.json"))
    with open(path) as f:
        out = json.load(f)
    return out["params"] if study == "titanic" else out["layers"]


# ------------------------------------------------------- the fleet, remote


def train_bert_fleet(lr, warmup_frac, reporter, ctx, out_dir):
    """slice_fleet's bulk trial: FLEET_BERT_STEPS BERT-base steps on slice's
    data under a warmup-cosine schedule, the state saved through
    ctx.save_checkpoint every FLEET_SAVE_EVERY steps and, on a preemption
    (the STOP a heartbeat draws surfaces as EarlyStopException at the next
    broadcast; the sweep stops nothing early), at the last step trained, so
    the ack carries it; with ctx.resume_step it restores that state and goes
    on at the step after it. Each attempt writes a record of its own."""
    from maggy_tpu_torch.exceptions import EarlyStopException
    from maggy_tpu_torch.models import BertEncoder
    from maggy_tpu_torch.train import Trainer, adamw, warmup_cosine_decay_schedule

    record = TrialRecord(out_dir, reporter)
    record.path = os.path.join(out_dir, "{}.{}.{}.json".format(
        reporter.trial_id, os.getpid(), time.monotonic_ns()))
    full_fp32()
    cfg, batch = bert_data()
    total = FLEET_BERT_STEPS
    sched = warmup_cosine_decay_schedule(0.0, lr, int(total * warmup_frac), total)
    trainer = Trainer(BertEncoder(cfg, device="meta"), adamw(sched), labels_loss,
                      device=DEVICE).init(seed=0)
    saved = None
    if ctx.resume_step is not None:
        state = ctx.restore_checkpoint({**trainer_state(trainer), "steps_done": 0})
        if state is None or state["steps_done"] != ctx.resume_step + 1:
            raise RuntimeError("trial {} resumes at step {} but its checkpoint holds {}".format(
                reporter.trial_id, ctx.resume_step, state and state["steps_done"]))
        trainer.model.load_state_dict(state["model"])
        trainer.optimizer.load_state_dict(state["optimizer"])
        trainer.scheduler.load_state_dict(state["scheduler"])
        record.first_step, saved = state["steps_done"], ctx.resume_step
    loss, i = None, record.first_step - 1
    with record:
        try:
            for i in range(record.first_step, total):
                loss = trainer.step(batch(i))
                record.steps += 1
                if (i + 1) % FLEET_SAVE_EVERY == 0:
                    ctx.save_checkpoint(i, {**trainer_state(trainer), "steps_done": i + 1})
                    saved = i
                if i % REPORT_EVERY == REPORT_EVERY - 1 or i == total - 1:
                    reporter.broadcast(-loss, step=i)
        except EarlyStopException:
            if loss is not None and saved != i:
                ctx.save_checkpoint(i, {**trainer_state(trainer), "steps_done": i + 1})
            raise
    final = float(loss)
    if not math.isfinite(final):
        raise FloatingPointError("non-finite loss {}".format(final))
    return {"metric": -final}


def fleet_tenant_journals(base):
    """{tenant name: its journal's events} of the experiments under ``base``."""
    from maggy_tpu_torch.telemetry import read_events

    out = {}
    for path in glob.glob(os.path.join(base, "*", "telemetry.jsonl")):
        events = read_events(path)
        name = next((e["name"] for e in events if e["ev"] == "experiment" and e.get("name")),
                    None)
        out[name] = events
    return out


def preempt_chain(events):
    """Each checkpointed preemption of a journal: its trial, the acked step,
    the step its resumption started from, request to ack and ack to resume
    in s."""
    out = []
    for e in events:
        if e["ev"] == "trial" and e["phase"] == "preempted" and e.get("checkpointed"):
            req = max((r["t"] for r in events if r["ev"] == "trial" and r["trial"] == e["trial"]
                       and r["phase"] == "preempt_requested" and r["t"] <= e["t"]), default=None)
            res = next((r for r in events if r["ev"] == "trial" and r["trial"] == e["trial"]
                        and r["phase"] == "resumed" and r["t"] >= e["t"]), None)
            out.append({"trial": e["trial"], "step": e.get("step"),
                        "resumed_from": None if res is None else res.get("from_step"),
                        "request_to_ack_s": None if req is None else e["t"] - req,
                        "preempt_to_resume_s": None if res is None else res["t"] - e["t"]})
    return out


def health_flags(events):
    counts = {}
    for e in events:
        if e["ev"] == "health" and e.get("status") == "raised":
            counts[e.get("check")] = counts.get(e.get("check"), 0) + 1
    return counts


def phase_slice_fleet(exp_root):
    """Phase 20: the shared fleet. (a) run_fleet_soak at its defaults; (b)
    the card soak, one Fleet(runners=2) hosting a BERT-base bulk tenant and
    an MNIST urgent one; (c) the monitor and the telemetry CLI on its home.
    Returns the card soak's flash launches."""
    from maggy_tpu_torch import OptimizationConfig, Searchspace, experiment
    from maggy_tpu_torch.fleet import Fleet
    from maggy_tpu_torch.fleet.soak import fleet_soak_report, run_fleet_soak
    from maggy_tpu_torch.ops import attention as A
    from maggy_tpu_torch.telemetry.trace import validate_trace
    from maggy_tpu_torch.train import warm

    t_phase = time.perf_counter()
    exp_root = fresh_dir(exp_root)
    closed = run_fleet_soak(base_dir=fresh_dir(os.path.join(exp_root, "closed_form")))
    emit("slice_fleet/closed_form", ok=closed["ok"], violations=closed["violations"],
         results=closed["results"], preempted=closed["preempted"],
         detail={k: v for k, v in closed["detail"].items() if k not in ("experiments", "goodput")},
         goodput_fraction=closed["detail"]["goodput"]["goodput_fraction"])
    if not closed["ok"] or closed["replay"]["preemptions"] < 1:
        raise AssertionError("slice_fleet: run_fleet_soak failed: {}".format(
            closed["violations"] or "no preemption"))

    gc.collect()
    torch.cuda.empty_cache()
    torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.reset_peak_memory_stats()
    base = fresh_dir(os.path.join(exp_root, "card"))
    bulk_records = fresh_dir(os.path.join(exp_root, "records_bulk"))
    urgent_records = fresh_dir(os.path.join(exp_root, "records_urgent"))
    cfg, _ = bert_data()

    def config(name, trials, space):
        return OptimizationConfig(name=name, num_trials=trials, optimizer="randomsearch",
                                  searchspace=space, direction="max", hb_interval=FLEET_HB_S,
                                  seed=0, es_policy="none", experiment_dir=base)

    bert_space = Searchspace(lr=("DOUBLE_LOG", [1e-5, 1e-3]),
                             warmup_frac=("DOUBLE", [0.0, 0.3]))
    fleet = Fleet(runners=2, home_dir=os.path.join(base, "fleet"),
                  preempt_grace_s=FLEET_GRACE_S)
    before = warm.counters()
    A.reset_launch_counts()
    t0 = time.perf_counter()
    with fleet:
        bulk = experiment.lagom_submit(
            functools.partial(train_bert_fleet, out_dir=bulk_records),
            config("bulk", FLEET_BULK_TRIALS, bert_space), fleet=fleet, priority="low",
            block=False)
        deadline = time.monotonic() + 120
        while bulk.entry.allocated() < 2 and not bulk.done() and time.monotonic() < deadline:
            time.sleep(0.02)
        saturated_s = time.perf_counter() - t0
        urgent = experiment.lagom_submit(
            functools.partial(train_mnist, budget=1, out_dir=urgent_records),
            config("urgent", FLEET_URGENT_TRIALS, chaos_space()), fleet=fleet,
            priority="high", min_runners=1, max_runners=1, block=False)
        results = {"bulk": bulk.result(timeout=400), "urgent": urgent.result(timeout=400)}
    wall = time.perf_counter() - t0
    launches = A.launch_counts()
    reading = warm_reading("slice_fleet", None, before)
    CAPTURED["bert_base_fleet"] = reading["captured"]
    report = fleet_soak_report(fleet, base, results, {"bulk": FLEET_BULK_TRIALS,
                                                      "urgent": FLEET_URGENT_TRIALS},
                               FLEET_STARVATION_S, wall)
    journals = fleet_tenant_journals(base)
    chain = preempt_chain(journals.get("bulk", []))
    records = read_records(bulk_records)
    steps = sum(r["steps"] for r in records)
    expected = cfg.num_layers * steps
    problems = list(report["violations"])
    if not any(c["resumed_from"] is not None and c["resumed_from"] == c["step"]
               for c in chain):
        problems.append("no checkpointed bulk trial resumed at its acked step: {}".format(chain))
    if any(n != expected for n in launches.values()) or expected == 0:
        problems.append("launches {} != {} layers x {} steps".format(
            launches, cfg.num_layers, steps))
    if len(read_records(urgent_records)) < FLEET_URGENT_TRIALS:
        problems.append("urgent tenant: {} trial records".format(
            len(read_records(urgent_records))))
    replay = report["replay"]
    fields = dict(
        wall_s=wall, bulk_saturated_s=saturated_s, results=report["results"],
        queue_wait_ms=replay["queue_wait_ms"], max_queue_wait_s=replay["max_queue_wait_s"],
        starvation_bound_s=FLEET_STARVATION_S, preemptions=replay["preemptions"],
        share=replay["share"], expected_share=replay["expected_share"],
        share_error=replay["share_error"],
        resumed_from_steps=report["detail"]["resumed_from_steps"], preempt_chain=chain,
        goodput={name: {k: t["goodput"].get(k) for k in ("goodput_fraction", "held_chip_s")}
                 | {"chip_seconds": t["chip_seconds"]}
                 for name, t in replay["goodput"]["tenants"].items()},
        bert_steps=steps, bert_attempts=len(records), launches=launches,
        expected_launches_each=expected,
        step_ms_median_with_saves=float(np.median([r["step_ms"] for r in records]))
        if records else None,
        warm=reading, health_flags={n: health_flags(ev) for n, ev in journals.items()},
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    if problems:
        emit("slice_fleet/card", problems=problems, **fields)
        raise AssertionError("slice_fleet: {}".format("; ".join(problems)))
    emit("slice_fleet/card", **fields)
    READINGS["slice_fleet_step_ms"] = fields["step_ms_median_with_saves"]

    home = fleet.home_dir
    clis = {}
    for name, argv in (("monitor", ["maggy_tpu_torch.monitor", "--fleet", home, "--once"]),
                       ("trace", ["maggy_tpu_torch.telemetry", "trace", home])):
        t1 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", *argv], cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, timeout=180)
        clis[name] = {"rc": proc.returncode, "s": time.perf_counter() - t1,
                      "stdout": proc.stdout.strip().splitlines()[:12]}
        if proc.returncode != 0:
            emit("slice_fleet/cli", **clis)
            raise AssertionError("slice_fleet: {} exited {}: {}".format(
                name, proc.returncode, proc.stderr[-2000:]))
    with open(os.path.join(home, "fleet_trace.json")) as f:
        clis["trace"]["events"] = validate_trace(json.load(f))
    for ckpt in glob.glob(os.path.join(base, "*", "*", "checkpoints")):
        shutil.rmtree(ckpt, ignore_errors=True)
    emit("slice_fleet", phase_s=time.perf_counter() - t_phase, cli=clis)
    return launches


def train_bert_remote(lr, warmup_frac, budget, reporter):
    """slice_remote's trial, named to its agents as chip_smoke:
    train_bert_remote: train_bert_asha with its records under the directory
    the agent's environment names."""
    return train_bert_asha(lr, warmup_frac, budget, reporter,
                           out_dir=os.environ[REMOTE_RECORDS_ENV])


def phase_slice_remote(exp_dir):
    """Phase 21: the slice sweep under pool="remote" on two agent
    processes, with the monitor polling it through its ticket. Returns the
    launches summed over the agents' trial records."""
    from maggy_tpu_torch import OptimizationConfig, Searchspace, experiment
    from maggy_tpu_torch.core import rpc
    from maggy_tpu_torch.ops import attention as A
    from maggy_tpu_torch.optimizers import Asha

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    exp_dir = fresh_dir(exp_dir)
    out_dir = fresh_dir(os.path.join(exp_dir, "records"))
    run_root = fresh_dir(os.path.join(exp_dir, "exp"))
    config = OptimizationConfig(
        name="bert_base_asha_remote", num_trials=9,
        optimizer=Asha(reduction_factor=3, resource_min=1, resource_max=9, seed=0),
        searchspace=Searchspace(lr=("DOUBLE_LOG", [1e-5, 1e-3]),
                                warmup_frac=("DOUBLE", [0.0, 0.3])),
        direction="max", num_workers=2, es_policy="median", es_min=3, hb_interval=0.1,
        seed=0, experiment_dir=run_root, pool="remote")
    joins, orig_join = {}, rpc.Server._join

    def timed_join(self, msg):
        reply = orig_join(self, msg)
        if reply.get("type") == "JOIN":
            joins[reply["partition_id"]] = time.time()
        return reply

    out, agents, monitors = {}, [], {}

    def sweep():
        try:
            out["result"] = experiment.lagom(None, config)
        except BaseException as e:  # noqa: BLE001 - reported below
            out["error"] = e

    rpc.Server._join = timed_join
    A.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        thread = threading.Thread(target=sweep, daemon=True, name="slice-remote-driver")
        thread.start()
        deadline = time.monotonic() + 60
        tickets = []
        while not tickets and time.monotonic() < deadline and "error" not in out:
            tickets = glob.glob(os.path.join(run_root, "*", "runner_ticket.json"))
            time.sleep(0.05)
        if not tickets:
            raise AssertionError("slice_remote: no join ticket: {!r}".format(out.get("error")))
        ticket = tickets[0]
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [ROOT] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]),
            **{REMOTE_RECORDS_ENV: out_dir})
        for i in range(2):
            log = open(os.path.join(exp_dir, "agent_{}.log".format(i)), "w")
            agents.append((subprocess.Popen(
                [sys.executable, "-m", "maggy_tpu_torch.runner", "--ticket", ticket,
                 "--train", REMOTE_TRAIN], cwd=ROOT, env=env, stdout=log,
                stderr=subprocess.STDOUT), log))
        # The polls start with the agents: a poll that reaches the driver
        # (exit 0) reached it while the sweep ran, since the driver's
        # server stops with the sweep.
        polls = {flag: subprocess.Popen(
            [sys.executable, "-m", "maggy_tpu_torch.monitor", "--ticket", ticket, "--once",
             *([flag] if flag else [])], cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True) for flag in ("", "--telem", "--health",
                                                            "--goodput")}
        for flag, proc in polls.items():
            stdout, stderr = proc.communicate(timeout=120)
            monitors[flag or "--log"] = {"rc": proc.returncode,
                                         "lines": stdout.strip().splitlines()[:6],
                                         "stderr": stderr[-500:] if proc.returncode else ""}
        for proc, log in agents:
            proc.wait(timeout=REMOTE_AGENT_TIMEOUT_S)
            log.close()
        thread.join(60)
    finally:
        rpc.Server._join = orig_join
        for proc, log in agents:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    wall = time.perf_counter() - t0
    agent_rcs = [proc.returncode for proc, _ in agents]
    if "error" in out or agent_rcs != [0, 0]:
        raise AssertionError("slice_remote: sweep {!r}, agents {}: {}".format(
            out.get("error"), agent_rcs,
            [log_tail(os.path.join(exp_dir, "agent_{}.log".format(i)), 30) for i in range(2)]))
    bad = {k: v for k, v in monitors.items() if v["rc"] != 0}
    if bad:
        raise AssertionError("slice_remote: monitor polls {}".format(bad))
    result = out["result"]
    records = read_records(out_dir)
    launches = {k: sum(r["launches"][k] for r in records) for k in A.launch_counts()}
    if any(A.launch_counts().values()):
        raise AssertionError("the driver process launched kernels in the remote sweep: "
                             "{}".format(A.launch_counts()))
    trials, promoted, total_steps, expected = check_bert_sweep(
        "slice_remote", result, exp_dir, records, launches)
    telemetry = journal_check("slice_remote", run_root, result)
    reading_warm = warm_reading("slice_remote", telemetry)
    CAPTURED["bert_base_remote"] = reading_warm["captured"]
    pids = sorted({r["pid"] for r in records})
    if os.getpid() in pids or len(pids) != 2:
        raise AssertionError("slice_remote: trials ran in processes {} (driver {})".format(
            pids, os.getpid()))
    first_running = {}
    for e in telemetry["_events"]:
        if e["ev"] == "trial" and e["phase"] == "running" and e.get("partition") is not None:
            first_running.setdefault(int(e["partition"]), e["t"])
    emit("slice_remote", trials_finished=len(trials), promoted=promoted,
         early_stopped=result["early_stopped"], best_val=result["best_val"],
         steps=total_steps, launches=launches, expected_launches_each=expected,
         sweep_wall_s=wall, step_ms_in_sweep_median=float(np.median(
             [r["step_ms"] for r in records])),
         process_step_ms_in_sweep_median=READINGS.get("slice_process_step_ms"),
         join_to_first_trial_s={str(p): first_running[p] - t for p, t in sorted(joins.items())
                                if p in first_running},
         agent_peak_mem_gb={str(pid): max(r["peak_mem_gb"] for r in records if r["pid"] == pid)
                            for pid in pids},
         time_split=time_split(records), runner_setup=runner_setup(telemetry),
         monitors=monitors, pipeline=pipeline_summary(result["pipeline"]), warm=reading_warm,
         telemetry=public(telemetry), phase_s=time.perf_counter() - t_phase)
    return launches


def train_bert_agents(lr, warmup_frac, reporter, steps=FLEET_BERT_STEPS, records=""):
    """slice_agents' BERT-base trial, run by an agent process (or a thread
    runner): slice_fleet's schedule without its checkpoints, on the agent's
    device (``--device``), its record under the directory the environment
    names (its ``records`` subdirectory)."""
    from maggy_tpu_torch.fleet.agent import trial_device
    from maggy_tpu_torch.models import BertEncoder
    from maggy_tpu_torch.train import Trainer, adamw, warmup_cosine_decay_schedule

    out_dir = os.path.join(os.environ[AGENTS_RECORDS_ENV], records)
    os.makedirs(out_dir, exist_ok=True)
    record = TrialRecord(out_dir, reporter)
    full_fp32()
    cfg, batch = bert_data()
    sched = warmup_cosine_decay_schedule(0.0, lr, int(steps * warmup_frac), steps)
    trainer = Trainer(BertEncoder(cfg, device="meta"), adamw(sched), labels_loss,
                      device=trial_device()).init(seed=0)
    with record:
        for i in range(steps):
            loss = trainer.step(batch(i))
            record.steps += 1
            if i % REPORT_EVERY == REPORT_EVERY - 1 or i == steps - 1:
                reporter.broadcast(-loss, step=i)
    final = float(loss)
    if not math.isfinite(final):
        raise FloatingPointError("non-finite loss {}".format(final))
    return {"metric": -final}


def train_bert_agents_kill(lr, warmup_frac, reporter):
    """slice_agents' killed tenant: train_bert_agents at AGENTS_KILL_STEPS,
    its records apart."""
    return train_bert_agents(lr, warmup_frac, reporter, steps=AGENTS_KILL_STEPS, records="kill")


def shipped_journal(home, name, local_dir=None):
    """A source's exactly-once journal: its sink segment merged with its
    local fallback journal, if it left one."""
    from maggy_tpu_torch.telemetry import read_events
    from maggy_tpu_torch.telemetry.sink import SINK_DIR_NAME, merge_source_events, sanitize_source

    path = os.path.join(home, SINK_DIR_NAME, sanitize_source(name) + ".jsonl")
    shipped = read_events(path) if os.path.exists(path) else None
    local_path = local_dir and os.path.join(local_dir, "telemetry.jsonl")
    local = read_events(local_path) if local_path and os.path.exists(local_path) else None
    return merge_source_events(shipped, local)


def phase_slice_agents(exp_root):
    """Phase 22: fleet agents and the journal sink. (a) run_agent_soak and
    run_sink_soak on the host; (b) one Fleet(runners=1, max_agents=2,
    sink=True) with two agent processes on the card, a BERT-base tenant on
    the agents and an MNIST tenant on the thread runner, every journal
    shipped to the sink; (c) one agent SIGKILLed mid-lease in a third tenant;
    (d) a profiled MNIST trial. Returns (b)'s flash launches, summed over its
    trials' records."""
    from maggy_tpu_torch import OptimizationConfig, Searchspace, experiment
    from maggy_tpu_torch.chaos.harness import check_invariants
    from maggy_tpu_torch.fleet import Fleet
    from maggy_tpu_torch.fleet.scheduler import replay_fleet_journal
    from maggy_tpu_torch.fleet.soak import (run_agent_soak, run_sink_soak, spawn_agent_process,
                                            stop_agent_processes)
    from maggy_tpu_torch.ops import attention as A
    from maggy_tpu_torch.runner import load_train_fn
    from maggy_tpu_torch.telemetry import read_events
    from maggy_tpu_torch.telemetry.sink import check_exactly_once, read_sink_dir

    t_phase = time.perf_counter()
    exp_root = fresh_dir(exp_root)
    for name, soak in (("agent_soak", functools.partial(run_agent_soak, agents=2, trials=4)),
                       ("sink_soak", functools.partial(run_sink_soak, tenants=2, trials=4))):
        t0 = time.perf_counter()
        report = soak(base_dir=fresh_dir(os.path.join(exp_root, name)), lock_witness=True)
        witness = witness_line(report["witness"])
        emit("slice_agents/" + name, ok=report["ok"], violations=report["violations"],
             wall_s=time.perf_counter() - t0, witness=witness,
             detail={k: v for k, v in report["detail"].items()
                     if k not in ("per_source", "witness")})
        if not report["ok"] or witness is None:
            raise AssertionError("slice_agents: {}: {} (witness {})".format(
                name, report["violations"], witness))

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = fresh_dir(os.path.join(exp_root, "card"))
    records_dir = fresh_dir(os.path.join(exp_root, "records"))
    kill_records = os.path.join(records_dir, "kill")
    mnist_records = fresh_dir(os.path.join(exp_root, "records_mnist"))
    cfg, _ = bert_data()
    bert_space = Searchspace(lr=("DOUBLE_LOG", [1e-5, 1e-3]),
                             warmup_frac=("DOUBLE", [0.0, 0.3]))

    def config(name, trials, space, **kw):
        return OptimizationConfig(name=name, num_trials=trials, optimizer="randomsearch",
                                  searchspace=space, direction="max", hb_interval=FLEET_HB_S,
                                  seed=0, es_policy="none", experiment_dir=base, sink=True, **kw)

    fleet = Fleet(runners=1, max_agents=2, sink=True, home_dir=os.path.join(base, "fleet"),
                  preempt_grace_s=FLEET_GRACE_S, agent_liveness_s=10.0)
    home = fleet.home_dir
    # The agents inherit this environment (the records' directory) and
    # import chip_smoke from ROOT, the package's directory.
    os.environ[AGENTS_RECORDS_ENV] = records_dir
    procs, out = [], {}
    logs = [os.path.join(exp_root, "agent_{}.log".format(i)) for i in range(2)]
    t0 = time.perf_counter()
    try:
        with fleet:
            for log in logs:
                procs.append(spawn_agent_process(os.path.join(home, "agent_ticket.json"),
                                                 log_path=log, device=DEVICE))
            deadline = time.monotonic() + AGENTS_JOIN_TIMEOUT_S
            while len(fleet.status()["agents"]) < 2 and time.monotonic() < deadline:
                if any(p.poll() is not None for p in procs):
                    raise AssertionError("slice_agents: an agent exited before joining: {}".format(
                        [log_tail(path, 30) for path in logs]))
                time.sleep(0.1)
            joined_s = time.perf_counter() - t0
            if len(fleet.status()["agents"]) < 2:
                raise AssertionError("slice_agents: {} agents joined in {} s".format(
                    len(fleet.status()["agents"]), AGENTS_JOIN_TIMEOUT_S))
            # MNIST first, as a partial: no name on the wire, so only the
            # thread runner serves it. The BERT tenant (at most two runners)
            # is named by module and leases the agents, or the thread runner
            # once it is free.
            mnist = experiment.lagom_submit(
                functools.partial(train_mnist, budget=1, out_dir=mnist_records),
                config("mnist", FLEET_URGENT_TRIALS, chaos_space()), fleet=fleet,
                max_runners=1, block=False)
            deadline = time.monotonic() + 60
            while mnist.entry.allocated() < 1 and not mnist.done() \
                    and time.monotonic() < deadline:
                time.sleep(0.02)
            A.reset_launch_counts()
            t_bert = time.perf_counter()
            bert = experiment.lagom_submit(
                load_train_fn(AGENTS_BERT_TRAIN), config("bert", FLEET_BULK_TRIALS, bert_space),
                fleet=fleet, max_runners=2, block=False)
            out["results"] = {"mnist": mnist.result(timeout=400), "bert": bert.result(timeout=400)}
            bert_wall = time.perf_counter() - t_bert
            driver_launches = A.launch_counts()

            # (c) A third tenant; one agent SIGKILLed once its trial passed
            # AGENTS_KILL_AT_STEP (the driver's store holds the steps its
            # heartbeats carried) or had been assigned AGENTS_KILL_AFTER_S.
            kill = experiment.lagom_submit(
                load_train_fn(AGENTS_KILL_TRAIN),
                config("bert_kill", AGENTS_KILL_TRIALS, bert_space,
                       hb_loss_timeout=AGENTS_HB_LOSS_S), fleet=fleet, max_runners=2, block=False)
            killed, deadline, first_seen, seen = None, time.monotonic() + 240, {}, {}
            while killed is None and time.monotonic() < deadline and not kill.done():
                drv = kill.entry.driver
                for rec in (fleet.agent_plane.snapshot() if drv is not None else []):
                    seen[rec["agent"]] = (rec["state"], rec["lease"], rec["pid"])
                    if rec["state"] != "leased" or rec["lease"] != "bert_kill" or rec["pid"] is None:
                        continue
                    tid = drv.server.reservations.get_assigned_trial(rec["pid"])
                    trial = drv.get_trial(tid) if tid is not None else None
                    if trial is None:
                        continue
                    age = time.monotonic() - first_seen.setdefault(tid, time.monotonic())
                    seen[rec["agent"]] += (tid, max(trial.step_history or [-1]), age)
                    if max(trial.step_history or [-1]) < AGENTS_KILL_AT_STEP \
                            and age < AGENTS_KILL_AFTER_S:
                        continue
                    drv.telemetry.event("chaos", kind="kill_agent", trial=tid,
                                        partition=rec["pid"], agent=rec["agent"])
                    killed = {"agent": rec["agent"], "trial": tid, "partition": rec["pid"],
                              "at_step": max(trial.step_history or [-1]), "assigned_s": age,
                              "signalled": fleet.agent_plane.kill_agent_by_runner(rec["runner"]),
                              "t": time.time()}
                    break
                time.sleep(0.02)
            out["kill"] = kill.result(timeout=400)
            exp_dirs = {name: h.entry.driver.exp_dir for name, h in
                        (("mnist", mnist), ("bert", bert), ("bert_kill", kill))}
            max_sids = {name: h.entry.driver.telemetry.journal.max_sid() for name, h in
                        (("mnist", mnist), ("bert", bert), ("bert_kill", kill))}
            fleet.agent_plane.stop()
            agent_rcs = []
            for proc in procs:
                try:
                    agent_rcs.append(proc.wait(timeout=30))
                except subprocess.TimeoutExpired:
                    agent_rcs.append(None)
    finally:
        stop_agent_processes(procs)
        os.environ.pop(AGENTS_RECORDS_ENV, None)
    wall = time.perf_counter() - t0

    problems = []
    records = read_records(records_dir)
    steps = sum(r["steps"] for r in records)
    launches = {k: sum(r["launches"][k] for r in records) for k in driver_launches}
    expected = cfg.num_layers * steps
    agent_pids = [p.pid for p in procs]
    # Trials by process: the agents', and any the fleet's thread runner took
    # in this process (its records count this process's launches).
    served = {str(pid): sum(1 for r in records if r["pid"] == pid)
              for pid in sorted({r["pid"] for r in records})}
    here = {k: sum(r["launches"][k] for r in records if r["pid"] == os.getpid())
            for k in driver_launches}
    if out["results"]["bert"]["num_trials"] != FLEET_BULK_TRIALS or \
            out["results"]["mnist"]["num_trials"] != FLEET_URGENT_TRIALS:
        problems.append("results {}".format({k: v["num_trials"] for k, v in out["results"].items()}))
    if not all(served.get(str(pid)) for pid in agent_pids):
        problems.append("BERT trials by process {}: not on both agents {}".format(
            served, agent_pids))
    if any(n != expected for n in launches.values()) or expected != \
            cfg.num_layers * FLEET_BULK_TRIALS * FLEET_BERT_STEPS:
        problems.append("launches {} != {} layers x {} steps".format(launches, cfg.num_layers,
                                                                     steps))
    if driver_launches != here:
        problems.append("this process launched {}, its trials' records say {}".format(
            driver_launches, here))
    if agent_rcs.count(0) != 1 or agent_rcs.count(-signal.SIGKILL) != 1:
        problems.append("agent exit codes {} (one SIGKILLed, one ending on AGSTOP)".format(
            agent_rcs))

    # The sink: every tenant's journal and both agents' exactly once.
    sources = read_sink_dir(os.path.join(home, "journal"))
    fleet_events = read_events(os.path.join(home, "fleet.jsonl"))
    agent_ids = [e["agent"] for e in fleet_events if e["ev"] == "agent" and e["phase"] == "join"]
    journals, sink_check = {}, {}
    for name in ("mnist", "bert", "bert_kill"):
        journals[name] = shipped_journal(home, name, exp_dirs[name])
        once = check_exactly_once(journals[name], expected_max_sid=max_sids[name])
        inv = check_invariants(journals[name], stall_flag_bound_s=None)
        sink_check[name] = {"events": len(journals[name]), "max_sid": max_sids[name],
                            "local_fallback": os.path.exists(
                                os.path.join(exp_dirs[name], "telemetry.jsonl")),
                            "exactly_once": once, "invariants": inv["violations"],
                            "trials": inv["trials"]}
        problems += ["{}: {}".format(name, v) for v in once + inv["violations"]]
    for aid in agent_ids:
        once = check_exactly_once(sources.get(aid) or [])
        sink_check["agent " + aid] = {"events": len(sources.get(aid) or []),
                                      "exactly_once": once}
        if not sources.get(aid):
            problems.append("agent {} shipped no journal".format(aid))
        problems += ["agent {}: {}".format(aid, v) for v in once]

    # (c) the killed agent: its trial requeued once (by the loss scan, or
    # by the BLACK path when its partition's next runner registers first),
    # its lease revoked.
    replay = replay_fleet_journal(os.path.join(home, "fleet.jsonl"))
    kill_events = journals["bert_kill"]
    requeues = [e.get("reason") for e in kill_events if e["ev"] == "trial"
                and e["phase"] == "requeued" and killed and e["trial"] == killed["trial"]]
    if killed is None or not killed["signalled"]:
        problems.append("no agent was killed mid-lease: {} (last seen {})".format(killed, seen))
    elif len(requeues) != 1 or requeues[0] not in ("heartbeat_loss", "blacklist") \
            or out["kill"]["num_trials"] != AGENTS_KILL_TRIALS:
        problems.append("killed trial requeued {}, tenant finished {} trials".format(
            requeues, out["kill"]["num_trials"]))
    if (replay["agents"]["losses"], replay["agents"]["lost_leases"]) != (1, 1):
        problems.append("fleet replay agents {}".format(replay["agents"]))
    lost_lease = [e for e in fleet_events if e["ev"] == "lease" and e.get("phase") == "end"
                  and e.get("reason") == "agent_lost"]
    # Each lease's end and each loss as the fleet saw them, and every
    # requeue of the killed tenant: what a wrong loss count is read from.
    agent_ends = [{k: e.get(k) for k in ("t", "agent", "phase", "exp", "pid", "reason", "detail")}
                  for e in fleet_events if e["ev"] == "agent" and e["phase"] in ("done", "lost")]
    kill_tenant_requeues = [{k: e.get(k) for k in ("t", "trial", "reason", "partition")}
                            for e in kill_events if e["ev"] == "trial"
                            and e["phase"] == "requeued"]

    first_lease = {}
    for e in fleet_events:
        if e["ev"] == "agent" and e["phase"] == "lease":
            first_lease.setdefault(e["agent"], e["t"])
    join_t = {e["agent"]: e["t"] for e in fleet_events if e["ev"] == "agent"
              and e["phase"] == "join"}
    reading = warm_reading("slice_agents", {"_events": journals["bert"]})
    CAPTURED["bert_base_agents"] = reading["captured"]

    # The unified trace over the fleet home.
    t1 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "maggy_tpu_torch.telemetry", "trace", "--unified",
                           home], cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                          text=True, timeout=180)
    unified = {"rc": proc.returncode, "s": time.perf_counter() - t1}
    if proc.returncode == 0:
        with open(os.path.join(home, "unified_trace.json")) as f:
            other = json.load(f)["otherData"]
        unified.update(agents=other["agents"], flows=other["flows"],
                       clock_offsets=other["clock_offsets"])
    else:
        problems.append("trace --unified exited {}: {}".format(proc.returncode,
                                                                proc.stderr[-1500:]))

    # (d) One profiled MNIST trial: a trace with the card's kernels.
    t1 = time.perf_counter()
    prof_dir = fresh_dir(os.path.join(exp_root, "profiled"))
    prof_result = experiment.lagom(
        functools.partial(train_mnist, budget=0.5, out_dir=fresh_dir(os.path.join(
            exp_root, "records_profiled"))),
        OptimizationConfig(name="mnist_profiled", num_trials=1, optimizer="randomsearch",
                           searchspace=chaos_space(), hb_interval=FLEET_HB_S, seed=0,
                           es_policy="none", experiment_dir=prof_dir, profile=True))
    traces = glob.glob(os.path.join(prof_dir, "*", "*", "tensorboard", "*.pt.trace.json"))
    profiled = {"trials": prof_result["num_trials"], "traces": len(traces),
                "kernel_events": trace_categories(traces[0]).get("kernel", 0) if traces else 0,
                "trace_bytes": os.path.getsize(traces[0]) if traces else 0,
                "s": time.perf_counter() - t1}
    if len(traces) != 1 or profiled["kernel_events"] == 0:
        problems.append("profile=True: {}".format(profiled))

    fields = dict(
        wall_s=wall, agents_joined_s=joined_s, bert_wall_s=bert_wall,
        results={k: v["num_trials"] for k, v in out["results"].items()},
        bert_steps=steps, launches=launches, expected_launches_each=expected,
        trials_per_agent=served, agent_exit_codes=agent_rcs,
        join_to_first_lease_s={a: first_lease[a] - join_t[a] for a in join_t if a in first_lease},
        agent_peak_mem_gb={str(pid): max((r["peak_mem_gb"] for r in records + (read_records(
            kill_records) if os.path.isdir(kill_records) else []) if r["pid"] == pid),
            default=None) for pid in agent_pids},
        step_ms_in_sweep_median=float(np.median([r["step_ms"] for r in records]))
        if records else None,
        fleet_step_ms_in_sweep_median=READINGS.get("slice_fleet_step_ms"),
        sink_ingest=replay.get("sink"), sink=sink_check, clock_offsets=replay.get("clock_offsets"),
        kill=killed, kill_requeues=requeues, lost_leases=len(lost_lease),
        kill_results=out["kill"]["num_trials"], agents_replay=replay["agents"],
        agent_ends=agent_ends, kill_tenant_requeues=kill_tenant_requeues,
        unified=unified, profiled=profiled, warm=reading,
        driver_peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
        phase_s=time.perf_counter() - t_phase)
    if problems:
        emit("slice_agents", problems=problems, **fields)
        raise AssertionError("slice_agents: {}".format("; ".join(problems)))
    emit("slice_agents", **fields)
    return launches


def dist_record(env, name, record):
    """A rank's record of a slice_dist run: ``<records>/<name>.rank<i>.json``."""
    path = os.path.join(os.environ[DIST_RECORDS_ENV],
                        "{}.rank{}.json".format(name, env.process_index))
    with open(path + ".tmp", "w") as f:
        json.dump(record, f)
    os.replace(path + ".tmp", path)


def seq_parallel_check(env, fn):
    """``fn`` (ring_attention or ulysses_attention, impl="flash") on this
    rank's shard of seeded bf16 q [1, DIST_S, 32, 128] and k, v [1, DIST_S,
    8, 128] (the Llama-3-8B attention of slice_dist's sequence), causal,
    forward and backward, against flash_attention on the whole sequence on
    this rank: each error beside the kernels phase's bf16 tolerance, and the
    exchanges the call made."""
    from maggy_tpu_torch.ops import attention as A
    from maggy_tpu_torch.parallel import collectives, split_sequence

    g = torch.Generator(device=env.device).manual_seed(5)

    def draw(heads):
        return torch.randn(1, DIST_S, heads, DIST_D, device=env.device,
                           generator=g).to(torch.bfloat16)

    q, k, v, do = draw(DIST_H), draw(DIST_HKV), draw(DIST_HKV), draw(DIST_H)
    whole = [x.clone().requires_grad_() for x in (q, k, v)]
    ref = A.flash_attention(*whole, None, True)
    ref.backward(do)
    n, i = env.axis_size("seq"), env.axis_index("seq")

    def shard(x):
        return split_sequence(x.detach(), n, i).contiguous()

    mine = [shard(x).requires_grad_() for x in (q, k, v)]
    collectives.reset_traffic()
    out = fn(*mine, env.group("seq"), causal=True, impl="flash")
    out.backward(shard(do))
    torch.cuda.synchronize()
    traffic = collectives.traffic()
    checks = {}
    for key, got, want in (("out", out, ref), ("dq", mine[0].grad, whole[0].grad),
                           ("dk", mine[1].grad, whole[1].grad),
                           ("dv", mine[2].grad, whole[2].grad)):
        want = shard(want)
        checks[key] = {"max_abs_err": float((got.detach().float() - want.float()).abs().max()),
                       "tol": tolerance(torch.bfloat16, want),
                       "finite": bool(torch.isfinite(got).all())}
    return {"checks": checks, "traffic": traffic,
            "ok": all(c["finite"] and c["max_abs_err"] <= c["tol"] for c in checks.values())}


def train_llama_sp(sharding_env, reporter=None):
    """A rank of slice_dist's llama3_8b_sp run: the ring check at its shape,
    then the LoRA Llama-3-8B (DIST_LAYERS layers, remat, attention_impl=
    "ring") on this rank's shard of batch 1 x DIST_S seeded tokens, labels
    shifted over the whole sequence, DIST_STEPS mesh-Trainer steps
    (strategy "sp"). Records losses, step times, this rank's kernel
    launches and exchanges over the steps, its peak memory."""
    import torch.distributed as dist

    from maggy_tpu_torch.models import Llama, LlamaConfig
    from maggy_tpu_torch.ops import attention as A
    from maggy_tpu_torch.ops import next_token_labels, sharded_next_token_loss
    from maggy_tpu_torch.parallel import collectives, ring_attention
    from maggy_tpu_torch.train import Trainer, adamw, only_lora

    env = sharding_env
    t_enter = time.perf_counter()
    check = seq_parallel_check(env, ring_attention)
    gc.collect()
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(LlamaConfig.llama3_8b(lora_rank=16), num_layers=DIST_LAYERS,
                              attention_impl="ring", seq_mesh=env.mesh)
    n_seq = env.axis_size("seq")
    trainer = Trainer(Llama(cfg, device="meta"), only_lora(adamw(1e-4)),
                      lambda out, b: sharded_next_token_loss(out[0], out[1], b["labels"], n_seq),
                      train_kwargs={"return_hidden": True}, env=env, strategy="sp").init(seed=0)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, size=(DIST_STEPS, 1, DIST_S))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    A.reset_launch_counts()
    collectives.reset_traffic()
    losses, step_ms = [], []
    setup_s = time.perf_counter() - t_enter
    for i in range(DIST_STEPS):
        t = torch.as_tensor(tokens[i])
        batch = trainer.place_batch({"inputs": (t,), "labels": next_token_labels(t)})
        t0 = time.perf_counter()
        loss = float(trainer.step(batch))  # the all-reduced loss: synced
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
        if reporter is not None:
            reporter.broadcast(loss, step=i)
    dist_record(env, "llama3_8b_sp", {
        "pid": os.getpid(), "rank": env.process_index, "device": str(env.device),
        "backend": str(dist.get_backend()), "losses": losses, "step_ms": step_ms,
        "launches": A.launch_counts(), "traffic": collectives.traffic(), "check": check,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "params": sum(p.numel() for p in trainer.model.parameters()), "setup_s": setup_s})
    return {"metric": losses[-1]}


def train_ulysses(sharding_env):
    """A rank of slice_dist's ulysses run: the Ulysses check at the ring's
    shape and world."""
    from maggy_tpu_torch.ops import attention as A
    from maggy_tpu_torch.parallel import ulysses_attention

    A.reset_launch_counts()
    check = seq_parallel_check(sharding_env, ulysses_attention)
    dist_record(sharding_env, "ulysses", {"pid": os.getpid(), "check": check,
                                          "launches": A.launch_counts(),
                                          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    return {"metric": check["checks"]["out"]["max_abs_err"]}


def train_resnet_dp(sharding_env, reporter=None):
    """examples/distributed_training.py's train function on the port:
    ResNet-18 width 16 (2 classes, CIFAR stem), SGD 0.05 with momentum 0.9,
    BatchNorm statistics updated in the step, batch 128 of 512 seeded
    32 x 32 x 3 images for 4 epochs through ShardedBatchIterator. A world of
    one runs no collective in its steps (a one-rank group is skipped), so
    the final loss is then all-reduced once over the world's NCCL group."""
    import torch.distributed as dist

    from maggy_tpu_torch.models import ResNet
    from maggy_tpu_torch.parallel import collectives
    from maggy_tpu_torch.train import ShardedBatchIterator, Trainer, cross_entropy_loss

    env = sharding_env
    rng = np.random.default_rng(0)
    X = rng.normal(size=(512, 32, 32, 3)).astype(np.float32)
    y = (X.mean(axis=(1, 2, 3)) > 0).astype(np.int64)

    def sgd(model):
        opt = torch.optim.SGD(model.parameters(), lr=0.05, momentum=0.9)
        return opt, torch.optim.lr_scheduler.LambdaLR(opt, lambda step: 1.0)

    trainer = Trainer(ResNet(depth=18, num_classes=2, width=16, device="meta"), sgd,
                      lambda out, b: cross_entropy_loss(out, b["labels"]),
                      has_aux_collections=True, train_kwargs={"train": True}, env=env,
                      strategy="dp").init(seed=0)
    it = ShardedBatchIterator({"x": X, "y": y}, batch_size=128, shard_count=env.shard_count,
                              current_shard=env.current_shard, epochs=4, seed=1, env=env)
    torch.cuda.reset_peak_memory_stats()
    collectives.reset_traffic()
    losses, step_ms = [], []
    for i, b in enumerate(it):
        t0 = time.perf_counter()
        loss = trainer.step({"inputs": (b["x"],), "labels": b["y"]})
        losses.append(float(loss))
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if reporter is not None and i % 4 == 0:
            reporter.broadcast(losses[-1], step=i)
    final = torch.tensor([losses[-1]], device=env.device)
    collectives.all_reduce_(final, dist.group.WORLD)
    dist_record(env, "resnet_dp", {
        "pid": os.getpid(), "backend": str(dist.get_backend()), "world": dist.get_world_size(),
        "losses": losses, "step_ms": step_ms, "all_reduced_loss": float(final),
        "traffic": collectives.traffic(), "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    return {"metric": losses[-1]}


def ring_schedule_launches(n, causal, layers, steps, remat):
    """The flash launches the ring's schedule makes, summed over its n
    ranks: a rank at index i runs the diagonal block and, causal, the i
    blocks strictly in its past (every block, full), each a forward (twice
    under remat: the layer runs again in the backward) and one dK/dV and one
    dQ launch of the backward (flash_block_bwd), for every layer and step."""
    blocks = n * (n + 1) // 2 if causal else n * n
    per = layers * steps * blocks
    return {"flash_fwd": per * (2 if remat else 1), "flash_bwd_dkdv": per, "flash_bwd_dq": per}


def dist_journal_check(name, exp_dir, workers):
    """Replay a distributed run's journal: whole, every worker registered
    and finalized once without an error, the experiment started and ended;
    returns the events, the rendezvous times and the problems."""
    from maggy_tpu_torch.telemetry import read_events

    paths = glob.glob(os.path.join(exp_dir, "*", "telemetry.jsonl"))
    if len(paths) != 1:
        return {"problems": ["{}: {} journals under {}".format(name, len(paths), exp_dir)]}
    events = read_events(paths[0])
    worker = [e for e in events if e["ev"] == "worker"]
    registered = sorted(e["partition"] for e in worker if e["phase"] == "registered")
    finalized = [e for e in worker if e["phase"] == "finalized"]
    phases = [e["phase"] for e in events if e["ev"] == "experiment"]
    problems = []
    if events.torn_lines:
        problems.append("{}: {} torn journal lines".format(name, events.torn_lines))
    if registered != list(range(workers)) or sorted(
            e["partition"] for e in finalized) != list(range(workers)):
        problems.append("{}: workers registered {} and finalized {} of {}".format(
            name, registered, [e["partition"] for e in finalized], workers))
    if any(e.get("error") for e in finalized):
        problems.append("{}: a worker finalized with an error".format(name))
    if phases[:1] != ["start"] or phases[-1:] != ["end"]:
        problems.append("{}: experiment phases {}".format(name, phases))
    return {"events": len(events), "torn_lines": events.torn_lines,
            "rendezvous_ms": {str(e["partition"]): e.get("rendezvous_ms") for e in finalized},
            "problems": problems}


def phase_slice_dist(exp_root, smi):
    """Phase 23: distributed training through lagom(train_fn,
    DistributedConfig(backend="process")). llama3_8b_sp: two rank processes
    sharing the card over gloo, a "seq" ring of the LoRA Llama-3-8B at full
    width; ulysses: Ulysses at the same shape and world; resnet_dp: the
    ResNet-18 of examples/distributed_training.py on a world of one, over
    NCCL. Returns the ring run's flash launches summed over its ranks."""
    import multiprocessing

    from maggy_tpu_torch import DistributedConfig, experiment

    t_phase = time.perf_counter()
    exp_root = fresh_dir(exp_root)
    records = fresh_dir(os.path.join(exp_root, "records"))
    os.environ[DIST_RECORDS_ENV] = records
    runs, problems = {}, []
    seq_world = dict(num_workers=DIST_RANKS, mesh_shape={"seq": DIST_RANKS}, strategy="sp")
    try:
        for name, fn, shape in (("llama3_8b_sp", train_llama_sp, seq_world),
                                ("ulysses", train_ulysses, seq_world),
                                ("resnet_dp", train_resnet_dp,
                                 dict(num_workers=1, mesh_shape={"data": 1}, strategy="dp"))):
            gc.collect()
            torch.cuda.empty_cache()
            exp_dir = fresh_dir(os.path.join(exp_root, name))
            t0 = time.perf_counter()
            try:
                result = experiment.lagom(fn, DistributedConfig(
                    name=name, backend="process", hb_interval=0.5,
                    hb_loss_timeout=DIST_TIMEOUT_S, experiment_dir=exp_dir, device=DEVICE,
                    **shape))
            except RuntimeError:
                # The ranks' tracebacks are in their logs: a failed rank's
                # world is killed before its own stderr says why.
                lines = [line for path in sorted(glob.glob(os.path.join(
                    exp_dir, "*", "worker_*.log"))) for line in open(path, errors="replace")]
                emit("slice_dist", failed=name, worker_logs="".join(lines[-120:]))
                raise
            wall = time.perf_counter() - t0
            ranks = [json.load(open(os.path.join(records, "{}.rank{}.json".format(name, r))))
                     for r in range(shape["num_workers"])]
            journal = dist_journal_check(name, exp_dir, shape["num_workers"])
            problems += journal.pop("problems")
            runs[name] = {"result": result, "wall_s": wall, "ranks": ranks, "journal": journal}
            if result["num_workers"] != shape["num_workers"] or \
                    len(result["per_worker"]) != shape["num_workers"]:
                problems.append("{}: result {}".format(name, result))
    finally:
        os.environ.pop(DIST_RECORDS_ENV, None)
        for p in multiprocessing.active_children():
            if p.name.startswith("runner-"):
                p.kill()
                p.join(10)

    sp, ul, rn = runs["llama3_8b_sp"], runs["ulysses"], runs["resnet_dp"]
    # The ring: equal finite losses on both ranks, its check, launches.
    losses = [r["losses"] for r in sp["ranks"]]
    if not (len(losses[0]) == DIST_STEPS and all(lo == losses[0] for lo in losses)
            and all(math.isfinite(x) for x in losses[0])):
        problems.append("llama3_8b_sp: rank losses {}".format(losses))
    launches = {k: sum(r["launches"][k] for r in sp["ranks"]) for k in REPLACES}
    expected = ring_schedule_launches(DIST_RANKS, True, DIST_LAYERS, DIST_STEPS, remat=True)
    if launches != expected:
        problems.append("llama3_8b_sp: launches {} != the ring's schedule {}".format(
            launches, expected))
    if {r["pid"] for r in sp["ranks"]} & {os.getpid()} or len({r["pid"] for r in sp["ranks"]}) \
            != DIST_RANKS or {r["backend"] for r in sp["ranks"]} != {"gloo"}:
        problems.append("llama3_8b_sp: ranks {}".format(
            [(r["pid"], r["backend"], r["device"]) for r in sp["ranks"]]))
    for name, run in (("llama3_8b_sp", sp), ("ulysses", ul)):
        for r in run["ranks"]:
            if not r["check"]["ok"]:
                problems.append("{}: rank {} off flash_attention on the whole sequence: "
                                "{}".format(name, run["ranks"].index(r), r["check"]["checks"]))
    if ul["ranks"][0]["check"]["traffic"].get("all_to_all", {}).get("calls") != 8:
        # Forward: q, k, v in and the output back; backward: the output's
        # gradient in and dq, dk, dv back.
        problems.append("ulysses: all-to-alls {}".format(ul["ranks"][0]["check"]["traffic"]))
    resnet = rn["ranks"][0]
    if not (resnet["backend"] == "nccl" and resnet["world"] == 1
            and all(math.isfinite(x) for x in resnet["losses"]) and len(resnet["losses"]) == 16
            and resnet["all_reduced_loss"] == resnet["losses"][-1]):
        problems.append("resnet_dp: {}".format({k: resnet[k] for k in (
            "backend", "world", "losses", "all_reduced_loss")}))

    def hop(rank):
        t = rank["traffic"].get("ring_hop") or {}
        return {"transport": t.get("transport"), "hops": t.get("calls"),
                "bytes_per_hop": t["bytes"] / t["calls"] if t else None,
                "ms_per_hop": t["ms"] / t["calls"] if t else None,
                "grad_all_reduce": rank["traffic"].get("grad_all_reduce"),
                "loss_all_reduce": rank["traffic"].get("loss_all_reduce")}

    fields = dict(
        nvidia_smi=smi,
        note="two rank processes time-slice one card: correctness, not scaling",
        llama3_8b_sp={
            "wall_s": sp["wall_s"], "ranks": DIST_RANKS, "layers": DIST_LAYERS,
            "tokens": [1, DIST_S], "steps": DIST_STEPS, "losses": losses[0],
            "step_ms_p50": [float(np.median(r["step_ms"][1:])) for r in sp["ranks"]],
            "step_ms": [r["step_ms"] for r in sp["ranks"]],
            "launches": launches, "expected_launches": expected,
            "launches_by_rank": [r["launches"] for r in sp["ranks"]],
            "exchanges": [hop(r) for r in sp["ranks"]],
            "peak_mem_gb": [r["peak_mem_gb"] for r in sp["ranks"]],
            "params": sp["ranks"][0]["params"], "setup_s": [r["setup_s"] for r in sp["ranks"]],
            "ring_check": [r["check"] for r in sp["ranks"]],
            "rendezvous_ms": sp["journal"]["rendezvous_ms"], "journal": sp["journal"]},
        ulysses={"wall_s": ul["wall_s"], "check": [r["check"] for r in ul["ranks"]],
                 "launches_by_rank": [r["launches"] for r in ul["ranks"]],
                 "peak_mem_gb": [r["peak_mem_gb"] for r in ul["ranks"]],
                 "rendezvous_ms": ul["journal"]["rendezvous_ms"], "journal": ul["journal"]},
        resnet_dp={"wall_s": rn["wall_s"], "backend": resnet["backend"],
                   "losses": resnet["losses"], "step_ms_p50": float(np.median(
                       resnet["step_ms"][1:])), "peak_mem_gb": resnet["peak_mem_gb"],
                   "traffic": resnet["traffic"], "rendezvous_ms": rn["journal"]["rendezvous_ms"],
                   "journal": rn["journal"]},
        phase_s=time.perf_counter() - t_phase)
    if problems:
        emit("slice_dist", problems=problems, **fields)
        raise AssertionError("slice_dist: {}".format("; ".join(problems)))
    emit("slice_dist", **fields)
    CAPTURED["dist"] = False
    return launches


# ---------------------------------------------------------------- slice_gang
# Gang-scheduled trials (maggy_tpu_torch/gang.py). GANG_STEPS steps each at
# BERT-base width, BERT_B rows a rank; ASHA(2, 1, 2) over GANG_TRIALS rung-0
# trials on GANG_RUNNERS thread runners: rung 0 on one chip, promotions as
# 2-chip "dp" gangs of rank processes.
GANG_STEPS = 3
GANG_TRIALS = 4
GANG_RUNNERS = 4
GANG_RECORDS_ENV = "MAGGY_TPU_SMOKE_GANG_RECORDS"
#: The remote gang's train function, by name on the wire.
GANG_TRAIN = "chip_smoke:train_bert_gang"


def gang_batch(i, rows):
    """Step ``i``'s global batch of ``rows`` rows, numpy from a seed (every
    rank draws the same one and takes its rows): BERT-base's vocabulary,
    padded length 128, key padding, every 8th row fully padded."""
    from maggy_tpu_torch.models import BertConfig

    vocab = BertConfig.base().vocab_size
    rng = np.random.default_rng(1000 + i)
    tokens = rng.integers(2, vocab, size=(rows, BERT_S))
    lens = rng.integers(16, BERT_S + 1, size=rows)
    lens[::8] = 0
    mask = np.arange(BERT_S)[None, :] < lens[:, None]
    labels = (((tokens > vocab // 2) & mask).sum(1) * 2 > lens).astype(np.int64)
    return {"inputs": (tokens, mask), "labels": labels}


def train_bert_gang(lr, reporter=None, ctx=None, budget=1, gang=None):
    """slice_gang's trial: BERT-base at full width for GANG_STEPS steps.
    Alone (a 1-chip trial) it runs in its runner thread, captured; in a gang
    each rank runs it eagerly on the mesh Trainer over the gang's world, on
    its BERT_B rows of the global batch. Writes a record per rank (losses,
    step times, launches, peak memory, world, rendezvous) under
    GANG_RECORDS_ENV."""
    import torch.distributed as dist

    from maggy_tpu_torch.ops import attention as A
    from maggy_tpu_torch.train import Trainer, adamw

    del budget, gang
    full_fp32()
    g = ctx.gang if ctx is not None else None
    t0 = time.perf_counter()
    env = g.sharding_env() if g is not None else None
    rendezvous_ms = (time.perf_counter() - t0) * 1e3
    rows = BERT_B * (g.size if g is not None else 1)
    if g is None:
        from maggy_tpu_torch.fleet.agent import trial_device

        device = trial_device()  # an agent's --device; "cuda" in a runner thread
    else:
        device = str(env.device)
    trainer = Trainer(bert_base_model(), adamw(lr), labels_loss, device=device, env=env,
                      strategy=g.strategy if g else "dp").init(seed=0)
    launches = A.launch_counts()
    losses, step_ms = [], []
    for i in range(GANG_STEPS):
        batch = trainer.place_batch(gang_batch(i, rows))
        t = time.perf_counter()
        loss = float(trainer.step(batch))
        step_ms.append((time.perf_counter() - t) * 1e3)
        losses.append(loss)
        if reporter is not None:
            reporter.broadcast(-loss, step=i)
    record = {"trial_id": ctx.trial_id if ctx is not None else None, "lr": lr,
              "rank": g.process_id if g is not None else None,
              "world": dist.get_world_size() if g is not None else 1,
              "backend": dist.get_backend() if g is not None else None,
              "pid": os.getpid(), "losses": losses, "step_ms": step_ms,
              "rendezvous_ms": rendezvous_ms,
              "launches": {k: n - launches[k] for k, n in A.launch_counts().items()},
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    out_dir = os.environ[GANG_RECORDS_ENV]
    path = os.path.join(out_dir, "{}.{}.{}.json".format(record["trial_id"], record["rank"],
                                                       os.getpid()))
    with open(path + ".tmp", "w") as f:
        json.dump(record, f)
    os.replace(path + ".tmp", path)
    if not all(math.isfinite(x) for x in losses):
        raise FloatingPointError("non-finite loss {}".format(losses))
    return {"metric": -losses[-1]}


def train_mnist_elastic(lr, batch, budget, reporter):
    """slice_gang's elastic trial: train_mnist (GANG_STEPS x 10 steps a
    budget unit) in an elastic runner process, after marking its budget and
    its lease's chip count."""
    from maggy_tpu_torch.core.runner_pool import lease_chips

    out_dir = os.environ[GANG_RECORDS_ENV]
    with open(os.path.join(out_dir, "elastic.{}.{}.{}".format(
            int(budget), len(lease_chips()), os.getpid())), "a") as f:
        f.write("x")
    return train_mnist(lr, batch, budget, reporter, out_dir=out_dir,
                       steps_per_budget=GANG_STEPS * 10)


def gang_losses_match(records, problems, name):
    """Per gang trial, its ranks' records: equal finite losses on every
    rank; returns {trial: ranks' records}."""
    by_trial = {}
    for r in records:
        if r["world"] > 1:
            by_trial.setdefault(r["trial_id"], []).append(r)
    for tid, ranks in by_trial.items():
        if sorted(r["rank"] for r in ranks) != list(range(ranks[0]["world"])):
            problems.append("{}: trial {} ranks {}".format(name, tid, [r["rank"] for r in ranks]))
        if any(r["losses"] != ranks[0]["losses"] for r in ranks) or \
                not all(math.isfinite(x) for x in ranks[0]["losses"]):
            problems.append("{}: trial {} rank losses {}".format(
                name, tid, [r["losses"] for r in ranks]))
    return by_trial


def phase_slice_gang(exp_root):
    """Phase 24: gang-scheduled trials. (a) bert_base_gang: the mixed
    in-process sweep, BERT-base ASHA(2, 1, 2) over GANG_TRIALS trials on
    GANG_RUNNERS thread runners with chips_per_budget {1: GangSpec(1), 2:
    GangSpec(2, "dp")}: rung 0 on one chip (captured), promotions as 2-chip
    gangs whose ranks are processes sharing the card over gloo; each gang
    trial's losses against a one-rank run at the global batch from the same
    weights, the launches summed over its ranks against 2 ranks x 12 layers
    x GANG_STEPS, no rank alive after. (b) bert_base_remote_gang: a 2-chip
    gang over two agent processes on one fleet. (c) run_gang_soak on the
    card: one gang member killed. (d) an elastic MNIST sweep. Returns the
    flash launches of (a) and (b), summed over their ranks."""
    from maggy_tpu_torch import GangSpec, OptimizationConfig, Searchspace, experiment
    from maggy_tpu_torch import gang as gang_mod
    from maggy_tpu_torch.chaos.harness import run_gang_soak
    from maggy_tpu_torch.fleet import Fleet
    from maggy_tpu_torch.fleet.soak import spawn_agent_process, stop_agent_processes
    from maggy_tpu_torch.optimizers import Asha
    from maggy_tpu_torch.runner import load_train_fn
    from maggy_tpu_torch.telemetry import read_events
    from maggy_tpu_torch.train import Trainer, adamw

    t_phase = time.perf_counter()
    exp_root = fresh_dir(exp_root)
    records_dir = fresh_dir(os.path.join(exp_root, "records"))
    os.environ[GANG_RECORDS_ENV] = records_dir
    problems, fields = [], {}
    from maggy_tpu_torch.models import BertConfig

    rel, absolute = AB_LOSS_TOL["bert_base"]
    layers = BertConfig.base().num_layers
    try:
        # (a) The mixed in-process sweep.
        gc.collect()
        torch.cuda.empty_cache()
        exp_dir = fresh_dir(os.path.join(exp_root, "bert_base_gang"))
        t0 = time.perf_counter()
        result = experiment.lagom(train_bert_gang, OptimizationConfig(
            name="bert_base_gang", num_trials=GANG_TRIALS,
            optimizer=Asha(reduction_factor=2, resource_min=1, resource_max=2, seed=0),
            searchspace=Searchspace(lr=("DOUBLE_LOG", [1e-5, 1e-4])), direction="max",
            chips_per_budget={1: GangSpec(1), 2: GangSpec(2, strategy="dp")},
            pool="thread", num_workers=GANG_RUNNERS, es_policy="none", hb_interval=0.5,
            experiment_dir=exp_dir))
        wall = time.perf_counter() - t0
        survivors = gang_mod.live_rank_pids()
        telemetry = journal_check("slice_gang/bert_base_gang", exp_dir, result)
        events = telemetry["_events"]
        pack = gang_mod.replay_pack(events)
        phases = [e["phase"] for e in events if e["ev"] == "trial"]
        records = read_records(records_dir)
        gangs = gang_losses_match(records, problems, "bert_base_gang")
        solo = [r for r in records if r["world"] == 1]
        gang_launches = {k: sum(r["launches"][k] for t in gangs.values() for r in t)
                         for k in REPLACES}
        expected = {k: 2 * layers * GANG_STEPS * len(gangs) for k in REPLACES}
        if len(gangs) < 2 or gang_launches != expected:
            problems.append("bert_base_gang: {} gang trials, launches {} != {}".format(
                len(gangs), gang_launches, expected))
        if survivors or any(gang_mod.pid_alive(r["pid"]) for t in gangs.values() for r in t):
            problems.append("bert_base_gang: rank processes alive after the sweep: {}".format(
                survivors))
        if phases.count("gang_assembled") != phases.count("gang_released") or \
                phases.count("gang_assembled") != len(gangs):
            problems.append("bert_base_gang: assembled {} released {} gang trials {}".format(
                phases.count("gang_assembled"), phases.count("gang_released"), len(gangs)))
        # Gate 1: each gang trial against one rank at the global batch.
        against = {}
        for tid, ranks in sorted(gangs.items()):
            lr = ranks[0]["lr"]
            ref = Trainer(bert_base_model(), adamw(lr), labels_loss, device=DEVICE,
                          warm_start=False).init(seed=0)
            ref_losses = [float(ref.step(ref.place_batch(gang_batch(i, 2 * BERT_B))))
                          for i in range(GANG_STEPS)]
            del ref
            gc.collect()
            off = max(abs(a - b) - (rel * abs(b) + absolute)
                      for a, b in zip(ranks[0]["losses"], ref_losses))
            against[tid] = {"gang": ranks[0]["losses"], "one_rank_b64": ref_losses,
                            "excess_over_tol": off}
            if off > 0:
                problems.append("bert_base_gang: trial {} off the one-rank run: {}".format(
                    tid, against[tid]))
        rank_records = [r for t in gangs.values() for r in t]
        fields["bert_base_gang"] = {
            "wall_s": wall, "num_trials": result["num_trials"], "pack": pack,
            "gangs_assembled": phases.count("gang_assembled"),
            "gangs_released": phases.count("gang_released"),
            "solo_step_ms_p50": float(np.median([x for r in solo for x in r["step_ms"][1:]])),
            "rank_step_ms_p50": float(np.median([x for r in rank_records
                                                 for x in r["step_ms"][1:]])),
            "rank_peak_mem_gb": {"{}.{}".format(r["trial_id"], r["rank"]): r["peak_mem_gb"]
                                 for r in rank_records},
            "rank_backends": sorted({r["backend"] for r in rank_records}),
            "rank_pids": sorted({r["pid"] for r in rank_records}),
            "launches": gang_launches, "expected_launches": expected, "against": against,
            "goodput": telemetry["goodput"], "telemetry": public(telemetry)}
        if set(fields["bert_base_gang"]["rank_backends"]) != {"gloo"} or \
                os.getpid() in fields["bert_base_gang"]["rank_pids"]:
            problems.append("bert_base_gang: ranks {}".format(
                [(r["pid"], r["backend"]) for r in rank_records]))

        # (b) A gang over two agent processes.
        for path in glob.glob(os.path.join(records_dir, "*.json")):
            os.remove(path)
        base = fresh_dir(os.path.join(exp_root, "remote"))
        fleet = Fleet(runners=0, max_agents=2, home_dir=os.path.join(base, "fleet"),
                      agent_liveness_s=30.0)
        logs = [os.path.join(base, "agent_{}.log".format(i)) for i in range(2)]
        procs = []
        t0 = time.perf_counter()
        try:
            with fleet:
                for log in logs:
                    procs.append(spawn_agent_process(
                        os.path.join(fleet.home_dir, "agent_ticket.json"), log_path=log,
                        device=DEVICE))
                remote = experiment.lagom_submit(load_train_fn(GANG_TRAIN), OptimizationConfig(
                    name="bert_base_remote_gang", num_trials=1, optimizer="randomsearch",
                    searchspace=Searchspace(lr=("DOUBLE_LOG", [1e-5, 1e-4]),
                                            gang=("GANG", [GangSpec(2, strategy="dp")])),
                    direction="max", hb_interval=0.5, hb_loss_timeout=60.0, seed=0,
                    es_policy="none", experiment_dir=base), fleet=fleet,
                    block=False).result(timeout=300)
                fleet.agent_plane.stop()
                for p in procs:
                    p.wait(timeout=30)
        except Exception:
            emit("slice_gang", failed="bert_base_remote_gang",
                 agent_logs=[log_tail(path, 40) for path in logs])
            raise
        finally:
            stop_agent_processes(procs)
        remote_wall = time.perf_counter() - t0
        remote_records = read_records(records_dir)
        remote_gangs = gang_losses_match(remote_records, problems, "bert_base_remote_gang")
        remote_launches = {k: sum(r["launches"][k] for r in remote_records) for k in REPLACES}
        remote_expected = {k: 2 * layers * GANG_STEPS for k in REPLACES}
        if remote["num_trials"] != 1 or len(remote_gangs) != 1 or \
                remote_launches != remote_expected or \
                {r["pid"] for r in remote_records} != {p.pid for p in procs}:
            problems.append("bert_base_remote_gang: trials {}, records {}, launches {}".format(
                remote["num_trials"], [(r["rank"], r["pid"]) for r in remote_records],
                remote_launches))
        fields["bert_base_remote_gang"] = {
            "wall_s": remote_wall, "losses": [r["losses"] for r in remote_records],
            "rendezvous_ms": {str(r["rank"]): r["rendezvous_ms"] for r in remote_records},
            "backend": sorted({r["backend"] for r in remote_records}),
            "step_ms_p50": float(np.median([x for r in remote_records
                                            for x in r["step_ms"][1:]])),
            "peak_mem_gb": [r["peak_mem_gb"] for r in remote_records],
            "launches": remote_launches, "agent_exit_codes": [p.returncode for p in procs]}

        # (c) The gang chaos soak, its ranks on the card.
        t0 = time.perf_counter()
        # Four trials, so the driver keeps four runners: the revoked gang
        # reassembles around the killed member's chip.
        soak = run_gang_soak(num_trials=4, workers=4, gang_chips=2, hb_loss_timeout=2.0,
                             base_dir=fresh_dir(os.path.join(exp_root, "chaos")))
        revoked = [r for r in soak["gang_revocations"] if r["outcome"] == "revoked"]
        soak_events = read_events(soak["journal"]) if soak.get("journal") else []
        requeues = [e for e in soak_events if e.get("ev") == "trial"
                    and e.get("phase") == "requeued" and e.get("reason") == "gang_member_lost"]
        if not soak["ok"] or len(revoked) != 1 or revoked[0]["requeues"] != 1 or \
                len(requeues) != 1:
            problems.append("gang chaos: ok {} violations {} revocations {}".format(
                soak["ok"], soak["violations"], soak["gang_revocations"]))
        fields["gang_chaos"] = {"wall_s": time.perf_counter() - t0, "ok": soak["ok"],
                                "revocations": soak["gang_revocations"],
                                "requeues": len(requeues),
                                "rank_survivors": soak["gang_rank_survivors"]}

        # (d) The elastic pool.
        exp_dir = fresh_dir(os.path.join(exp_root, "elastic"))
        t0 = time.perf_counter()
        elastic = experiment.lagom(train_mnist_elastic, OptimizationConfig(
            name="elastic", num_trials=2,
            optimizer=Asha(reduction_factor=2, resource_min=1, resource_max=2, seed=0),
            searchspace=Searchspace(lr=("DOUBLE_LOG", [1e-4, 1e-2]),
                                    batch=("DISCRETE", [128])),
            direction="max", pool="elastic", num_workers=1, total_chips=2,
            chips_per_budget={1: 1, 2: 2}, es_policy="none", hb_interval=0.5,
            experiment_dir=exp_dir))
        markers = [m.split(".")[1:3] for m in os.listdir(records_dir)
                   if m.startswith("elastic.")]
        (journal,) = glob.glob(os.path.join(exp_dir, "*", "telemetry.jsonl"))
        held, peak, starts, resized = 0, 0, {}, 0
        for ev in read_events(journal):
            if ev["ev"] != "lease":
                continue
            held += ev["capacity"] if ev["phase"] == "start" else -ev["capacity"]
            peak = max(peak, held)
            if ev["phase"] == "start":
                starts[ev["partition"]] = starts.get(ev["partition"], 0) + 1
        resized = sum(n - 1 for n in starts.values())
        if elastic["num_trials"] < 3 or any(chips != budget for budget, chips in markers) or \
                not markers or peak > 2 or held != 0 or resized < 1:
            problems.append("elastic: trials {}, (budget, chips) {}, peak lease {}, held at end "
                            "{}, respawns {}".format(elastic["num_trials"], markers, peak, held,
                                                     resized))
        fields["elastic"] = {"wall_s": time.perf_counter() - t0,
                             "num_trials": elastic["num_trials"],
                             "budget_chips": sorted(markers), "peak_leased_chips": peak,
                             "respawns": resized}
    finally:
        os.environ.pop(GANG_RECORDS_ENV, None)
    fields["phase_s"] = time.perf_counter() - t_phase
    if problems:
        emit("slice_gang", problems=problems, **fields)
        raise AssertionError("slice_gang: {}".format("; ".join(problems)))
    emit("slice_gang", **fields)
    CAPTURED["bert_base_gang"] = False
    return {k: gang_launches[k] + remote_launches[k] for k in REPLACES}


# ------------------------------------------------------------ slice_parallel
# Sharded parameters, expert and pipeline parallelism (parallel/sharded.py,
# parallel/pipeline.py) through lagom(train_fn, DistributedConfig(...)) on
# PAR_RANKS rank processes sharing the card over gloo. The three process
# runs share one world (its start-up paid once), each on a mesh of its own
# over it; the pipeline runs over two remote agents. Each run against the
# one-device run of the same model, seed and global batch (PAR_LOSS_TOL:
# slice_gang's 1e-2 x |loss| + 1e-3). Depths: the 4-layer LoRA Llama-3-8B of
# slice_dist (remat), slice_moe's 4-layer MoE Llama (8 experts, top 2,
# capacity 2.0), BERT-base whole; PipelinedLM at Llama-3-8B's widths, 2
# stages of 2 layers, 4 microbatches of 1 x 2048.
PAR_RANKS = 2
PAR_LLAMA_LAYERS, PAR_S = 4, 2048
PAR_RUNS = {"llama3_8b_tp": {"mesh": {"model": PAR_RANKS}, "strategy": "tp", "steps": 4},
            "bert_base_fsdp": {"mesh": {"fsdp": PAR_RANKS}, "strategy": "fsdp", "steps": 3},
            "llama3_8b_moe_ep": {"mesh": {"expert": PAR_RANKS}, "strategy": "ep", "steps": 3}}
PAR_PIPE = {"vocab": 128256, "hidden": 4096, "intermediate": 14336, "stages": PAR_RANKS,
            "layers": 2, "microbatches": 4, "batch": 4}
PAR_LOSS_TOL = (1e-2, 1e-3)
# Each step's loss change from step 0, ranks against one device: a gradient
# summed where a mean belongs, or a shard that never updates, moves it. The
# largest gap read on the H100 was 8.3e-4 (llama3_8b_tp's step 3, against
# moves of up to 0.094); PAR_LOSS_TOL alone is wider than all of training.
PAR_DELTA_TOL = 1.5e-3
PAR_RECORDS_ENV = "MAGGY_TPU_SMOKE_PAR_RECORDS"
PAR_PIPE_TRAIN = "chip_smoke:train_pipelined_lm"
PAR_TIMEOUT_S = 300
PAR_LR = 1e-4


def par_model(name):
    """Run ``name``'s model on the meta device: BERT-base, the MoE Llama or
    the LoRA Llama-3-8B at PAR_LLAMA_LAYERS layers."""
    from maggy_tpu_torch.models import Llama, LlamaConfig

    if name == "bert_base_fsdp":
        return bert_base_model()
    cfg = moe_config() if name == "llama3_8b_moe_ep" else dataclasses.replace(
        LlamaConfig.llama3_8b(lora_rank=16), num_layers=PAR_LLAMA_LAYERS)
    return Llama(cfg, device="meta")


def par_trainer(name, env=None):
    """``name``'s Trainer from seed 0: one device (``env`` None, eager) or a
    rank of the mesh ``env``."""
    from maggy_tpu_torch.ops import chunked_next_token_loss
    from maggy_tpu_torch.train import Trainer, adamw, only_lora

    kw = dict(device=str(env.device) if env is not None else DEVICE, env=env,
              strategy=PAR_RUNS[name]["strategy"] if env is not None else "dp",
              warm_start=False)
    if name == "bert_base_fsdp":
        return Trainer(par_model(name), adamw(PAR_LR), labels_loss, **kw).init(seed=0)
    return Trainer(par_model(name), only_lora(adamw(PAR_LR)),
                   lambda out, b: chunked_next_token_loss(out[0], out[1], b["tokens"]),
                   train_kwargs={"return_hidden": True}, **kw).init(seed=0)


def par_batch(name, i):
    """Step ``i``'s global batch of run ``name``, numpy from a seed: 64 rows
    of BERT-base (32 a rank under fsdp), or 1 x PAR_S Llama-3 tokens (the
    same on every rank: tp and ep cut no batch)."""
    if name == "bert_base_fsdp":
        return gang_batch(i, PAR_RANKS * BERT_B)
    t = np.random.default_rng(300 + i).integers(0, 128256, size=(1, PAR_S))
    return {"inputs": (t,), "tokens": t}


def par_launches(name, ranks=1):
    """The flash launches of run ``name`` summed over ``ranks``: each layer
    and step a forward (twice under the Llamas' remat), a dK/dV and a dQ."""
    layers = 12 if name == "bert_base_fsdp" else PAR_LLAMA_LAYERS
    n = layers * PAR_RUNS[name]["steps"] * ranks
    return {"flash_fwd": n * (1 if name == "bert_base_fsdp" else 2), "flash_bwd_dkdv": n,
            "flash_bwd_dq": n}


def peak_over(base, device=None):
    """GB allocated at the peak since the last reset, over ``base`` (the
    bytes allocated before the run began): what the run itself held, not
    what earlier phases of the process left."""
    return (torch.cuda.max_memory_allocated(device) - base) / 1e9


def par_steps(name, trainer, base):
    """The run's steps on ``trainer``: losses, step times, and the peak
    memory of the steps over ``base`` (the model and optimizer included)."""
    torch.cuda.synchronize(trainer.device)
    torch.cuda.reset_peak_memory_stats(trainer.device)
    losses, step_ms = [], []
    for i in range(PAR_RUNS[name]["steps"]):
        batch = trainer.place_batch(par_batch(name, i))
        t0 = time.perf_counter()
        losses.append(float(trainer.step(batch)))
        step_ms.append((time.perf_counter() - t0) * 1e3)
    return losses, step_ms, peak_over(base, trainer.device)


def par_expected_shapes(name, env):
    """{parameter: shape} the logical rules give this run's model on its
    mesh (every parameter, whole where nothing cuts it)."""
    from maggy_tpu_torch.parallel import sharding

    model = par_model(name)
    specs = sharding.logical_placements(model, env.mesh, PAR_RUNS[name]["strategy"])
    out = {}
    for n, p in model.named_parameters():
        shape = list(p.shape)
        for d, axis in enumerate(specs[n]):
            if axis is not None:
                shape[d] //= env.axis_size(axis)
        out[n] = tuple(shape)
    return out


#: Parameters whose shard shapes slice_parallel prints.
PAR_SHOWN = ("layers.0.attn.q_proj.weight", "layers.0.attn.o_proj.weight", "embedding",
             "lm_head", "layers.0.moe_mlp.gate_proj", "layers.0.moe_mlp.router",
             "tok_embedding", "layers.0.q_proj.weight", "layers.0.o_proj.weight",
             "pooler.weight")


def train_parallel(sharding_env, reporter=None):
    """A rank of slice_parallel's process world: each run of PAR_RUNS on a
    mesh of its own over the world (``parallel.make_mesh``), from seed 0,
    its launches and exchanges counted from zero just before its steps and
    read just after. Records per run: losses, step times, launches,
    exchanges, peak memory of init and steps, shard shapes and whether
    every parameter's shape is what the logical rules give."""
    import torch.distributed as dist

    from maggy_tpu_torch.ops import attention as A
    from maggy_tpu_torch.parallel import ShardingEnv, collectives, make_mesh

    full_fp32()
    world = sharding_env
    metric = None
    for k, (name, run) in enumerate(PAR_RUNS.items()):
        t0 = time.perf_counter()
        env = ShardingEnv(make_mesh(run["mesh"], device_type=world.device.type),
                          world.process_index, world.process_count, world.device)
        mesh_s = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated(env.device)
        torch.cuda.reset_peak_memory_stats(env.device)
        trainer = par_trainer(name, env)
        init_s = time.perf_counter() - t0 - mesh_s
        init_peak = peak_over(base, env.device)
        shapes = {n: tuple(p.shape) for n, p in trainer.model.named_parameters()}
        want = par_expected_shapes(name, env)
        A.reset_launch_counts()
        collectives.reset_traffic()
        losses, step_ms, peak = par_steps(name, trainer, base)
        record = {"pid": os.getpid(), "rank": env.process_index,
                  "backend": str(dist.get_backend()), "world": dist.get_world_size(),
                  "mesh": run["mesh"], "losses": losses, "step_ms": step_ms,
                  "launches": A.launch_counts(), "traffic": collectives.traffic(),
                  "peak_mem_gb": peak, "init_peak_mem_gb": init_peak, "init_s": init_s,
                  "mesh_s": mesh_s, "shards": {n: shapes[n] for n in PAR_SHOWN if n in shapes},
                  "shapes_ok": shapes == want,
                  "shape_mismatch": {n: (shapes.get(n), want.get(n)) for n in
                                     set(shapes) | set(want) if shapes.get(n) != want.get(n)},
                  "cut": len(trainer.shard_shapes),
                  "params": sum(p.numel() for p in trainer.model.parameters())}
        dist_record(env, name, record)
        metric = losses[-1]
        if reporter is not None:
            reporter.broadcast(metric, step=k)
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
    return {"metric": metric}


def pipe_model(stages, device):
    from maggy_tpu_torch.parallel import PipelinedLM

    c = PAR_PIPE
    return PipelinedLM(c["vocab"], c["hidden"], c["intermediate"], c["stages"], c["layers"],
                       dtype=torch.bfloat16, stages=stages, device=device)


def pipe_tokens(device):
    c = PAR_PIPE
    return torch.as_tensor(np.random.default_rng(400).integers(
        0, c["vocab"], size=(c["batch"], PAR_S)), device=device)


def pipe_loss(hidden, head, tokens):
    """The mean over the microbatches (a row each) of each one's chunked
    next-token loss: what 1F1B's loss is, microbatch by microbatch."""
    from maggy_tpu_torch.ops import chunked_next_token_loss

    M = PAR_PIPE["microbatches"]
    rows = hidden.shape[0] // M
    return torch.stack([chunked_next_token_loss(hidden[m * rows:(m + 1) * rows], head,
                                                tokens[m * rows:(m + 1) * rows])
                        for m in range(M)]).mean()


def pipe_reference_path():
    return os.path.join(ROOT, "build", "chip_smoke_pipe_reference.pt")


def train_pipelined_lm(sharding_env, reporter=None):
    """A rank (a remote agent) of slice_parallel's pipelined_lm run: this
    rank's stage of PipelinedLM from seed 0 on the {"pipe": 2} mesh.
    pipeline_1f1b_grads, then one GPipe step (pipeline_apply, autograd, SGD
    on the stage; the embedding and head, which every rank holds whole as
    in JAX, stay frozen); the pipeline's output against the one-device
    apply_sequential (``pipe_reference_path``), 1F1B's loss and stage
    gradients against GPipe's. The peak memory of each (over what the
    process held before the stage was built) is read apart: 1F1B's
    gradients wait in host memory during the GPipe step."""
    import torch.distributed as dist

    from maggy_tpu_torch.ops import attention as A
    from maggy_tpu_torch.ops import chunked_next_token_loss
    from maggy_tpu_torch.parallel import collectives, pipeline

    full_fp32()
    env = sharding_env
    stage = pipeline.stage_param_sharding(env)
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(env.device)
    t0 = time.perf_counter()
    lm = pipe_model([stage], env.device)
    lm.init_weights(torch.Generator(device=env.device).manual_seed(0))
    lm.embed.requires_grad_(False)
    lm.head.requires_grad_(False)
    tokens = pipe_tokens(env.device)
    ref = torch.load(pipe_reference_path(), map_location="cpu")
    init_s = time.perf_counter() - t0
    A.reset_launch_counts()
    collectives.reset_traffic()
    M = PAR_PIPE["microbatches"]
    head = lm.head.detach().to(torch.bfloat16)
    x = lm.embed.detach().to(torch.bfloat16)[tokens]
    torch.cuda.synchronize(env.device)
    torch.cuda.reset_peak_memory_stats(env.device)
    t1 = time.perf_counter()
    loss_1f1b, grads_1f1b = pipeline.pipeline_1f1b_grads(
        lm.stage_fn, lambda act, tgt: chunked_next_token_loss(act, head, tgt),
        {k: v.detach() for k, v in lm.stage_params(stage).items()}, x, tokens, env,
        num_microbatches=M)
    loss_1f1b = float(loss_1f1b)
    ms_1f1b = (time.perf_counter() - t1) * 1e3
    peak_1f1b = peak_over(base, env.device)
    grads_1f1b = {k: g.cpu() for k, g in grads_1f1b.items()}
    del head, x
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize(env.device)
    torch.cuda.reset_peak_memory_stats(env.device)
    t2 = time.perf_counter()
    hidden, head_p = lm.apply(tokens, env, num_microbatches=M, return_hidden=True)
    loss = pipe_loss(hidden, head_p, tokens)
    loss.backward()
    with torch.no_grad():
        for p in lm.parameters():
            if p.grad is not None:
                p.sub_(0.01 * p.grad)
    loss = loss.item()
    ms_gpipe = (time.perf_counter() - t2) * 1e3
    peak = peak_over(base, env.device)
    grads = {k: getattr(lm, k).grad[0].cpu() for k in pipeline.STAGE_LEAVES}
    checks = {}
    for key, got, want in [("out_vs_sequential", hidden.detach().cpu(), ref["hidden"])] + [
            ("grad_" + k, grads_1f1b[k], grads[k]) for k in pipeline.STAGE_LEAVES]:
        checks[key] = {"max_abs_err": float((got.float() - want.float()).abs().max()),
                       "tol": tolerance(torch.bfloat16, want),
                       "finite": bool(torch.isfinite(got).all())}
    record = {"pid": os.getpid(), "rank": env.process_index, "stage": stage,
              "backend": str(dist.get_backend()), "world": dist.get_world_size(),
              "loss_gpipe": loss, "loss_1f1b": loss_1f1b, "loss_reference": ref["loss"],
              "checks": checks, "ms_1f1b": ms_1f1b, "ms_gpipe_step": ms_gpipe,
              "launches": A.launch_counts(), "traffic": collectives.traffic(),
              "peak_mem_gb": peak, "peak_mem_1f1b_gb": peak_1f1b, "init_s": init_s,
              "stage_shape": list(lm.w_gate.shape),
              "params": sum(p.numel() for p in lm.parameters())}
    dist_record(env, "pipelined_lm", record)
    return {"metric": loss}


def par_reference():
    """The one-device runs, one after another and each freed: every
    PAR_RUNS model at its global batch (losses, peak memory of the steps and
    of init), and PipelinedLM's apply_sequential with its loss and
    backward, the embedding and head frozen as on the ranks (the output
    saved for the ranks)."""
    refs = {}
    for name in PAR_RUNS:
        gc.collect()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        trainer = par_trainer(name)
        init_peak = peak_over(base)
        losses, step_ms, peak = par_steps(name, trainer, base)
        refs[name] = {"losses": losses, "step_ms": step_ms, "peak_mem_gb": peak,
                      "init_peak_mem_gb": init_peak, "wall_s": time.perf_counter() - t0}
        del trainer
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    lm = pipe_model(None, DEVICE)
    lm.init_weights(torch.Generator(device=DEVICE).manual_seed(0))
    lm.embed.requires_grad_(False)
    lm.head.requires_grad_(False)
    tokens = pipe_tokens(DEVICE)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    hidden, head = lm.apply_sequential(tokens, return_hidden=True)
    loss = pipe_loss(hidden, head, tokens)
    loss.backward()
    os.makedirs(os.path.dirname(pipe_reference_path()), exist_ok=True)
    torch.save({"hidden": hidden.detach().cpu(), "loss": loss.item()}, pipe_reference_path())
    refs["pipelined_lm"] = {"loss": loss.item(), "wall_s": time.perf_counter() - t0,
                            "peak_mem_gb": peak_over(base)}
    del lm, hidden, head, loss
    gc.collect()
    torch.cuda.empty_cache()
    return refs


def remote_dist_run(name, exp_dir, train, env_extra, **config_kw):
    """``lagom(train, DistributedConfig(backend="remote"))`` with its ranks
    as two ``python -m maggy_tpu_torch.runner`` agent processes started
    here; returns (result, wall, agent pids and exit codes). Every agent is
    killed in a ``finally``."""
    from maggy_tpu_torch import DistributedConfig, experiment

    out, agents = {}, []
    run_root = fresh_dir(os.path.join(exp_dir, "exp"))

    def drive():
        try:
            out["result"] = experiment.lagom(train, DistributedConfig(
                name=name, backend="remote", bind_host="127.0.0.1", hb_interval=0.5,
                hb_loss_timeout=DIST_TIMEOUT_S, experiment_dir=run_root, device=DEVICE,
                **config_kw))
        except BaseException as e:  # noqa: BLE001 - reported below
            out["error"] = e

    t0 = time.perf_counter()
    thread = threading.Thread(target=drive, daemon=True, name="slice-parallel-driver")
    try:
        thread.start()
        tickets, deadline = [], time.monotonic() + 60
        while not tickets and time.monotonic() < deadline and "error" not in out:
            tickets = glob.glob(os.path.join(run_root, "*", "runner_ticket.json"))
            time.sleep(0.05)
        if not tickets:
            raise AssertionError("{}: no join ticket: {!r}".format(name, out.get("error")))
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [ROOT] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]),
            **env_extra)
        for i in range(config_kw["num_workers"]):
            log = open(os.path.join(exp_dir, "agent_{}.log".format(i)), "w")
            agents.append((subprocess.Popen(
                [sys.executable, "-m", "maggy_tpu_torch.runner", "--ticket", tickets[0],
                 "--train", PAR_PIPE_TRAIN], cwd=ROOT, env=env, stdout=log,
                stderr=subprocess.STDOUT), log))
        for proc, _ in agents:
            proc.wait(timeout=PAR_TIMEOUT_S)
        thread.join(60)
    finally:
        for proc, log in agents:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    rcs = [proc.returncode for proc, _ in agents]
    if "error" in out or rcs != [0] * len(agents):
        raise AssertionError("{}: {!r}, agents {}: {}".format(
            name, out.get("error"), rcs, [log_tail(os.path.join(exp_dir, "agent_{}.log".format(
                i)), 40) for i in range(len(agents))]))
    return out["result"], time.perf_counter() - t0, [p.pid for p, _ in agents], rcs, run_root


def phase_slice_parallel(exp_root, smi):
    """Phase 25: sharded parameters, expert and pipeline parallelism through
    lagom(train_fn, DistributedConfig(...)) on ranks sharing the card over
    gloo. llama3_8b_tp (the LoRA Llama-3-8B, tp: 16 query and 4 kv heads a
    rank), bert_base_fsdp (BERT-base, fsdp) and llama3_8b_moe_ep (the MoE
    Llama, 4 experts a rank) on one world of PAR_RANKS rank processes, each
    on its own mesh; pipelined_lm (PipelinedLM, GPipe and 1F1B) over two
    remote agents. The one-device runs go first and are freed. Checked per
    run: equal finite losses on every rank within PAR_LOSS_TOL of one device
    at the global batch and each step's loss change within PAR_DELTA_TOL of
    one device's, every parameter's shape what the logical rules give,
    each rank's peak memory of the steps (GPipe's and 1F1B's for the
    pipeline; each over what its process held before) below the one-device
    run's, flash
    launches exact (0 for the pipeline), the pipeline's output against
    apply_sequential and 1F1B's loss and gradients against GPipe's, the
    journal, no rank alive after. Returns the three process runs' launches
    summed over their ranks."""
    import multiprocessing

    from maggy_tpu_torch import DistributedConfig, experiment
    from maggy_tpu_torch.gang import pid_alive
    from maggy_tpu_torch.train import clear_warm

    t_phase = time.perf_counter()
    clear_warm()
    exp_root = fresh_dir(exp_root)
    records = fresh_dir(os.path.join(exp_root, "records"))
    t0 = time.perf_counter()
    refs = par_reference()
    ref_s = time.perf_counter() - t0
    problems, runs = [], {}
    os.environ[DIST_RECORDS_ENV] = records
    try:
        exp_dir = fresh_dir(os.path.join(exp_root, "process_world"))
        first = next(iter(PAR_RUNS.values()))
        t0 = time.perf_counter()
        try:
            result = experiment.lagom(train_parallel, DistributedConfig(
                name="slice_parallel", backend="process", num_workers=PAR_RANKS,
                mesh_shape=first["mesh"], strategy=first["strategy"], hb_interval=0.5,
                hb_loss_timeout=DIST_TIMEOUT_S, experiment_dir=exp_dir, device=DEVICE))
        except RuntimeError:
            lines = [line for path in sorted(glob.glob(os.path.join(
                exp_dir, "*", "worker_*.log"))) for line in open(path, errors="replace")]
            emit("slice_parallel", failed="process_world", worker_logs="".join(lines[-120:]))
            raise
        world = {"result": result, "wall_s": time.perf_counter() - t0,
                 "journal": dist_journal_check("slice_parallel", exp_dir, PAR_RANKS)}
        problems += world["journal"].pop("problems")
        for name in PAR_RUNS:
            runs[name] = [json.load(open(os.path.join(records, "{}.rank{}.json".format(
                name, r)))) for r in range(PAR_RANKS)]
        pipe_dir = fresh_dir(os.path.join(exp_root, "pipelined_lm"))
        p_result, p_wall, agent_pids, agent_rcs, p_root = remote_dist_run(
            "pipelined_lm", pipe_dir, train_pipelined_lm, {DIST_RECORDS_ENV: records},
            num_workers=PAR_RANKS, mesh_shape={"pipe": PAR_RANKS}, strategy="dp")
        pipe_journal = dist_journal_check("pipelined_lm", p_root, PAR_RANKS)
        problems += pipe_journal.pop("problems")
        pipe = [json.load(open(os.path.join(records, "pipelined_lm.rank{}.json".format(r))))
                for r in range(PAR_RANKS)]
    finally:
        os.environ.pop(DIST_RECORDS_ENV, None)
        for p in multiprocessing.active_children():
            if p.name.startswith("runner-"):
                p.kill()
                p.join(10)

    rel, absolute = PAR_LOSS_TOL
    fields, launches = {}, {}
    for name, ranks in runs.items():
        ref = refs[name]
        losses = [r["losses"] for r in ranks]
        excess = max(abs(a - b) - (rel * abs(b) + absolute)
                     for a, b in zip(losses[0], ref["losses"]))
        delta_gap = max(abs((a - losses[0][0]) - (b - ref["losses"][0]))
                        for a, b in zip(losses[0], ref["losses"]))
        if not (all(lo == losses[0] for lo in losses) and len(losses[0]) ==
                PAR_RUNS[name]["steps"] and all(math.isfinite(x) for x in losses[0])
                and excess <= 0 and delta_gap <= PAR_DELTA_TOL):
            problems.append("{}: rank losses {} against one device {} (step changes "
                            "differ by {} > {}?)".format(name, losses, ref["losses"],
                                                         delta_gap, PAR_DELTA_TOL))
        if not all(r["shapes_ok"] for r in ranks) or not all(r["cut"] for r in ranks):
            problems.append("{}: shapes off the logical rules: {}".format(
                name, [r["shape_mismatch"] for r in ranks]))
        if any(r["peak_mem_gb"] >= ref["peak_mem_gb"] for r in ranks):
            problems.append("{}: rank peak memory {} not below one device's {}".format(
                name, [r["peak_mem_gb"] for r in ranks], ref["peak_mem_gb"]))
        launches[name] = {k: sum(r["launches"][k] for r in ranks) for k in REPLACES}
        expected = par_launches(name, PAR_RANKS)
        if launches[name] != expected:
            problems.append("{}: launches {} != {}".format(name, launches[name], expected))
        if {r["backend"] for r in ranks} != {"gloo"} or len({r["pid"] for r in ranks}) != \
                PAR_RANKS or any(pid_alive(r["pid"]) for r in ranks):
            problems.append("{}: ranks {}".format(name, [(r["pid"], r["backend"], pid_alive(
                r["pid"])) for r in ranks]))
        fields[name] = {
            "mesh": PAR_RUNS[name]["mesh"], "strategy": PAR_RUNS[name]["strategy"],
            "losses": losses[0], "one_device_losses": ref["losses"], "excess_over_tol": excess,
            "step_change_gap": delta_gap, "step_change_tol": PAR_DELTA_TOL,
            "step_ms_p50": [float(np.median(r["step_ms"][1:])) for r in ranks],
            "one_device_step_ms_p50": float(np.median(ref["step_ms"][1:])),
            "peak_mem_gb": [r["peak_mem_gb"] for r in ranks],
            "one_device_peak_mem_gb": ref["peak_mem_gb"],
            "init_peak_mem_gb": [r["init_peak_mem_gb"] for r in ranks],
            "one_device_init_peak_mem_gb": ref["init_peak_mem_gb"],
            "shards": ranks[0]["shards"], "params_cut": ranks[0]["cut"],
            "params_a_rank": ranks[0]["params"], "launches": launches[name],
            "expected_launches": expected,
            "traffic": [r["traffic"] for r in ranks], "init_s": [r["init_s"] for r in ranks]}
    # The pipeline: its checks, launches 0, the same losses on both ranks.
    p_launches = {k: sum(r["launches"][k] for r in pipe) for k in REPLACES}
    ref = refs["pipelined_lm"]
    p_excess = max(abs(r[k] - ref["loss"]) - (rel * abs(ref["loss"]) + absolute)
                   for r in pipe for k in ("loss_gpipe", "loss_1f1b"))
    bad = {r["rank"]: {k: c for k, c in r["checks"].items()
                       if not (c["finite"] and c["max_abs_err"] <= c["tol"])} for r in pipe}
    if any(bad.values()) or p_excess > 0 or any(p_launches.values()) or \
            len({r["loss_gpipe"] for r in pipe}) != 1 or \
            len({r["loss_1f1b"] for r in pipe}) != 1 or \
            sorted(r["pid"] for r in pipe) != sorted(agent_pids) or \
            any(pid_alive(p) for p in agent_pids) or p_result["num_workers"] != PAR_RANKS:
        problems.append("pipelined_lm: checks {}, losses {} against {}, launches {}, "
                        "pids {} agents {}".format(bad, [(r["loss_gpipe"], r["loss_1f1b"])
                                                         for r in pipe], ref["loss"],
                                                   p_launches, [r["pid"] for r in pipe],
                                                   agent_pids))
    if any(max(r["peak_mem_gb"], r["peak_mem_1f1b_gb"]) >= ref["peak_mem_gb"] for r in pipe):
        problems.append("pipelined_lm: rank peak memory (GPipe, 1F1B) {} not below one "
                        "device's {}".format([(r["peak_mem_gb"], r["peak_mem_1f1b_gb"])
                                              for r in pipe], ref["peak_mem_gb"]))
    fields["pipelined_lm"] = {
        "mesh": {"pipe": PAR_RANKS}, "backend": "remote", "widths": PAR_PIPE,
        "loss_gpipe": pipe[0]["loss_gpipe"], "loss_1f1b": pipe[0]["loss_1f1b"],
        "one_device_loss": ref["loss"], "excess_over_tol": p_excess,
        "checks": [r["checks"] for r in pipe], "ms_1f1b": [r["ms_1f1b"] for r in pipe],
        "ms_gpipe_step": [r["ms_gpipe_step"] for r in pipe],
        "peak_mem_gb": [r["peak_mem_gb"] for r in pipe],
        "peak_mem_1f1b_gb": [r["peak_mem_1f1b_gb"] for r in pipe],
        "one_device_peak_mem_gb": ref["peak_mem_gb"], "launches": p_launches,
        "stage_shape": pipe[0]["stage_shape"], "params_a_rank": pipe[0]["params"],
        "traffic": [r["traffic"] for r in pipe], "wall_s": p_wall,
        "agent_exit_codes": agent_rcs, "rendezvous_ms": pipe_journal["rendezvous_ms"],
        "journal": pipe_journal}
    fields.update(nvidia_smi=smi, world_wall_s=world["wall_s"],
                  rendezvous_ms=world["journal"]["rendezvous_ms"], journal=world["journal"],
                  one_device_s=ref_s, one_device=refs,
                  note="two rank processes time-slice one card: correctness, not scaling",
                  phase_s=time.perf_counter() - t_phase)
    if problems:
        emit("slice_parallel", problems=problems, **fields)
        raise AssertionError("slice_parallel: {}".format("; ".join(problems)))
    emit("slice_parallel", **fields)
    for name in PAR_RUNS:
        CAPTURED[name] = False
    return launches


def bert_base_model():
    """BERT-base at full width (12 x 768, 12 heads, vocab 30522), built on
    the meta device, without dropout: a gang's ranks and the one-rank run
    it is held to draw no masks, so their losses compare."""
    from maggy_tpu_torch.models import BertConfig, BertEncoder

    return BertEncoder(dataclasses.replace(BertConfig.base(), dropout=0.0), device="meta")


def fresh_dir(path):
    shutil.rmtree(path, ignore_errors=True)
    os.makedirs(path)
    return path


def main():
    from maggy_tpu_torch.train import clear_warm

    if os.path.exists(PHASE_LOG):
        os.remove(PHASE_LOG)
    share_bytecode()
    smi = phase_device()
    phase_build()
    main_times = phase_kernels()
    bert_launches, asha_step_ms, slice_reading = phase_slice(
        os.path.join(ROOT, "build", "chip_smoke_experiments"))
    launches = {
        "bert_base": bert_launches,
        "bert_base_bo": phase_slice_bo(os.path.join(ROOT, "build", "chip_smoke_experiments_bo"),
                                       asha_step_ms),
        "llama3_8b": phase_slice_llama(
            fresh_dir(os.path.join(ROOT, "build", "chip_smoke_experiments_llama"))),
        "danube_1_8b": phase_slice_danube(
            fresh_dir(os.path.join(ROOT, "build", "chip_smoke_experiments_danube"))),
        "llama3_8b_lora_lanes": phase_slice_lora_lanes(
            fresh_dir(os.path.join(ROOT, "build", "chip_smoke_experiments_lora_lanes"))),
        **phase_slice_examples(os.path.join(ROOT, "build", "chip_smoke_experiments_examples")),
        "bert_base_process": phase_slice_process(
            os.path.join(ROOT, "build", "chip_smoke_experiments_process"), asha_step_ms)}
    clear_warm()
    phase_slice_mnist(os.path.join(ROOT, "build", "chip_smoke_experiments_mnist"))
    phase_slice_recovery(fresh_dir(os.path.join(ROOT, "build", "chip_smoke_experiments_recovery")))
    clear_warm()
    launches["bert_base_fork"] = phase_slice_fork(
        os.path.join(ROOT, "build", "chip_smoke_experiments_fork"), slice_reading)
    clear_warm()
    launches["bert_base_objstore"] = phase_slice_objstore(
        os.path.join(ROOT, "build", "chip_smoke_experiments_objstore"), smi)
    phase_slice_pbt(os.path.join(ROOT, "build", "chip_smoke_experiments_pbt"))
    launches["bert_base_resume"] = phase_slice_resume()
    clear_warm()
    launches["bert_base_warm"], warm_bert_losses = phase_slice_warm(
        os.path.join(ROOT, "build", "chip_smoke_experiments_warm"))
    clear_warm()
    phase_slice_resnet(os.path.join(ROOT, "build", "chip_smoke_experiments_resnet"))
    phase_slice_vit(os.path.join(ROOT, "build", "chip_smoke_experiments_vit"))
    launches["llama3_8b_moe"] = phase_slice_moe(
        fresh_dir(os.path.join(ROOT, "build", "chip_smoke_experiments_moe")))
    clear_warm()
    launches["bert_base_lanes"], launches["llama3_8b_moe_lanes"] = phase_slice_lanes(
        os.path.join(ROOT, "build", "chip_smoke_experiments_lanes"), warm_bert_losses)
    phase_slice_chaos()
    launches["bert_base_loco"] = phase_slice_ablation(
        os.path.join(ROOT, "build", "chip_smoke_experiments_ablation"))
    clear_warm()
    launches["bert_base_fleet"] = phase_slice_fleet(
        os.path.join(ROOT, "build", "chip_smoke_experiments_fleet"))
    clear_warm()
    launches["bert_base_remote"] = phase_slice_remote(
        os.path.join(ROOT, "build", "chip_smoke_experiments_remote"))
    clear_warm()
    launches["bert_base_agents"] = phase_slice_agents(
        os.path.join(ROOT, "build", "chip_smoke_experiments_agents"))
    clear_warm()
    launches["dist"] = phase_slice_dist(os.path.join(ROOT, "build", "chip_smoke_experiments_dist"),
                                        smi)
    clear_warm()
    launches["bert_base_gang"] = phase_slice_gang(
        os.path.join(ROOT, "build", "chip_smoke_experiments_gang"))
    clear_warm()
    launches.update(phase_slice_parallel(
        os.path.join(ROOT, "build", "chip_smoke_experiments_parallel"), smi))
    kernels = [{"name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES[name],
                "path": path, "launches": launches[path][name], "captured": CAPTURED[path],
                **main_times[SAME_SHAPE.get(path, path)][name]}
               for path in launches for name in REPLACES]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                            "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--resume-child"]:
        resume_child(sys.argv[2], int(sys.argv[3]))
    else:
        main()
