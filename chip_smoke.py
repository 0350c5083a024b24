"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises (non-zero exit):

1. device  — the card, and nvidia-smi's name/power-limit line.
2. build   — nvcc builds every CUDA source of maggy_tpu_torch/ops/csrc.
3. kernels — each flash-attention kernel against its plain PyTorch version
             (bf16, bf16 with fp32 gradients, and fp32; the BERT-base
             training shape with a padding mask that fully masks some rows,
             a causal GQA shape, causal padded shapes at S=256 with fully
             padded rows, and the Llama-3-8B training shape: causal, GQA
             32:8, D=128, S=2048), dQ also in the mode that computes delta
             from the forward's output, each error beside its tolerance;
             each kernel's registers, local memory, shared memory and
             resident blocks per SM (failing if a D=64 tensor-core kernel
             spills; bf16 D=128 local memory printed); kernel, plain and
             scaled_dot_product_attention times at both main paths' shapes
             (SDPA's forward, backward and both are yardsticks, never used
             by the port).
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
             device time per launch).
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
6. slice_llama — the Llama-3-8B LoRA sweep (32 x 4096, vocab 128256,
             32/8 heads, remat) through experiment.lagom: ASHA over
             (lora_rank, lora_alpha, lr) on two thread runners, each trial
             building the full model, only the adapters trained, batches of
             2 x 2048 tokens, the vocab-chunked loss. Launch counters are
             zeroed just before and read just after: the forward kernel
             runs twice per layer and step (remat), the backward kernels
             once. Then a 2-layer full-width model on the card against the
             CPU path (hidden states, loss, layer-0 adapter gradients), the
             chunked loss's time, the step time alone, a torch.profiler
             breakdown of three steps, and the phase's peak memory.
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
             make_data(2048) under RandomSearch(seed 7) + Hyperband(1, 9, 3)
             over lr and batch, 20 steps a budget unit, two thread runners,
             each trial marking a file named after its params and budget.
             Both must show incarnation 1 killed by the signal and 2 exiting
             0, driver epochs [1, 2] in the markers and the journal, one
             resumed and one recovered event (in flight >= 1), no trial
             finalized before the kill running again, each trial in flight
             at the kill requeued once (blacklist or heartbeat_loss) and
             finalized after the resume, early_stopped counting both
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
             bracket file present at the kill, every slot of the 22 run,
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
             seeded 1024 x 32 x 32 x 3 set on the card, 8 steps a budget
             unit, a heartbeat every 2. Every step after a unit's first at
             its shape must replay a graph. Then 5 steps replayed against the
             same 5 taken eagerly from the same start at lr 0: the running
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
             TPE, 8 trials of 12 steps, 2 threads, a plain adamw(lr) (each
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
reruns its thread sweep with telemetry off and on in turns, twice
(telemetry's cost where the host sets the pace).

Then the {"kernels": [...]} summary line (one entry per kernel and main
path, each with that path's launches, whether its steps ran captured, and
times at its shape; bert_base_resume's launches are incarnation 2's,
bert_base_warm's slice_warm's BERT-base warm arm's, llama3_8b_moe's
slice_moe's at the Llama shape's times, bert_base_lanes's slice_lanes'
at the folded shape, 4 lanes x batch 32), the
nvidia-smi line, and the last
line {"ok": true, "device": {...}}. Needs one CUDA card; imports nothing of
JAX or maggy_tpu. Runner processes are spawned and re-import this file as
``__mp_main__``: importing it does no CUDA work, and their train functions
are the module-level ``train_*`` below.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import gc
import glob
import json
import math
import os
import re
import shutil
import signal
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
# Llama-3-8B LoRA fine-tune: batch 2 x 2048 tokens (BASELINE.md config 5).
LLAMA_B, LLAMA_S = 2, 2048
LLAMA_STEPS_PER_BUDGET = 2
# The Bayesian-optimization sweeps of examples/bert_glue_hpo.py. Cuts: TPE
# runs 14 trials of 16 steps (the example: 8 trials; TPE fits its KDEs only
# from 2(d+1) = 8 finalized trials, and a suggestion prefetched while two
# trials run sees about k - 3 of its k predecessors finalized, so only the
# 12th and later can be model proposals); GP + Hyperband runs 4 steps per
# budget unit; a heartbeat every 4 steps.
BO_TPE_TRIALS, BO_TPE_STEPS, BO_STEPS_PER_BUDGET, BO_REPORT_EVERY = 14, 16, 4, 4
#: (batch, Sq, Sk, heads, kv heads, head dim) of each main path's attention;
#: the BO sweeps add batch 64 (their search space is batch in {32, 64}).
MAIN_SHAPES = {"bert_base": (BERT_B, BERT_S, BERT_S, 12, 12, 64),
               "bert_base_bo": (64, BERT_S, BERT_S, 12, 12, 64),
               "llama3_8b": (LLAMA_B, LLAMA_S, LLAMA_S, 32, 8, 128),
               "bert_base_lanes": (4 * BERT_B, BERT_S, BERT_S, 12, 12, 64)}
#: Paths that run the kernels at another path's shape: the process-runner,
#: forking, resumed and warm A/B sweeps are the slice sweep's, the MoE
#: Llama's attention is the Llama's.
SAME_SHAPE = {"bert_base_process": "bert_base", "bert_base_fork": "bert_base",
              "bert_base_resume": "bert_base", "bert_base_warm": "bert_base",
              "llama3_8b_moe": "llama3_8b"}
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
# Hyperband sweep's bracket ladder and steps a budget unit (bench.py trains
# 40; cut, since the sweep only shows the bracket state across a crash),
# how long incarnation 1 may take to reach its kill point and incarnation 2
# to finish.
RESUME_ROOT = os.path.join(ROOT, "build", "chip_smoke_experiments_resume")
CHILD_SCRIPT = os.path.abspath(__file__)
RESUME_LOSS_TIMEOUT_S = 3.0
RESUME_HYPERBAND = {"min_budget": 1, "max_budget": 9, "eta": 3}
MNIST_RESUME_STEPS_PER_BUDGET = 20
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
RESNET_STEPS_PER_BUDGET, RESNET_REPORT_EVERY = 8, 2
RESNET_BN_STEPS, RESNET_BN_RTOL, RESNET_LOGIT_RTOL = 5, 1e-5, 1e-3
# slice_vit (examples/vit_cifar_hpo.py with ViTConfig.base(num_classes=2)):
# batch 64 of a seeded 512-image set (the example steps its whole set at
# once), 12 steps a trial, 8 TPE trials on two runners, a heartbeat every 4.
VIT_N, VIT_BATCH, VIT_STEPS, VIT_TRIALS, VIT_REPORT_EVERY = 512, 64, 12, 8, 4
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
# the BERT-base sweep's lanes.
LANES_K, LANES_TRIALS, LANES_SEED, LANES_BATCH = 8, 25, 7, 256
LANES_BENCH_STEPS, LANES_REPORT_EVERY, LANES_ARM_BUDGET_S = 2500, 100, 20.0
LANES_PARITY_LRS, LANES_PARITY_STEPS, LANES_MASK_AT = [1e-3, 3e-3, 1e-2, 3e-2], 25, 10
LANES_TOL = (1e-4, 1e-5)
BERT_LANES = 4
#: The steps a trial of slice_lanes' MNIST arms trains (set by the phase).
LANES_STEPS = [LANES_BENCH_STEPS]


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


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
    sources = build.compile_all()
    for name in sources:
        build.library(name)
    ptxas = [line.strip() for name in sources
             for line in build.build_logs.get(name, "").splitlines() if "Used" in line]
    emit("build", sources=sources, seconds=time.perf_counter() - t0,
         ptxas_register_lines=len(ptxas), ptxas_sample=ptxas[:3])


def make_inputs(B, Sq, Sk, H, Hkv, D, dtype, padded, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(B, Sq, H, D, device="cuda", generator=g).to(dtype)
    k = torch.randn(B, Sk, Hkv, D, device="cuda", generator=g).to(dtype)
    v = torch.randn(B, Sk, Hkv, D, device="cuda", generator=g).to(dtype)
    do = torch.randn(B, Sq, H, D, device="cuda", generator=g).to(dtype)
    mask = None
    if padded:
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


def phase_kernels():
    from maggy_tpu_torch.ops import attention as A

    # causal_pad_*: causal with padding and fully padded batch rows at
    # S=256, where the row's mean of V spans the unskipped 128-key tiles.
    cases = [("bert_base", MAIN_SHAPES["bert_base"], False, True),
             ("bert_base_bo", MAIN_SHAPES["bert_base_bo"], False, True),
             ("bert_base_lanes", MAIN_SHAPES["bert_base_lanes"], False, True),
             ("causal_gqa", (2, 128, 1024, 32, 8, 128), True, False),
             ("causal_pad_gqa", (8, 256, 256, 8, 2, 64), True, True),
             ("causal_pad_d96", (8, 256, 256, 4, 4, 96), True, True),
             ("llama3_8b", MAIN_SHAPES["llama3_8b"], True, False)]
    results, main = [], {path: {} for path in MAIN_SHAPES}
    for label, shape, causal, padded in cases:
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
                if label in main and not variant and dtype == torch.bfloat16:
                    main[label][name] = {"max_abs_err": err}
    A.reset_launch_counts()

    # What each kernel takes on the card, per head dim and type (and, for
    # the backward, per gradient type).
    variants = [(torch.bfloat16, False), (torch.bfloat16, True), (torch.float32, False)]
    resources = [{"kernel": name, "D": D, "dtype": str(dtype), "grad_fp32": g32,
                  **A.kernel_resources(name, D, dtype, g32)}
                 for name in REPLACES for D in A.KERNEL_HEAD_DIMS
                 for dtype, g32 in variants if not (g32 and name == "flash_fwd")]
    spilling = [r for r in resources if r["D"] == 64 and r["dtype"] == str(torch.bfloat16)
                and r["local_bytes"]]
    if spilling:
        emit("kernels", checks=results, resources=resources)
        raise AssertionError("tensor-core kernels use local memory at D=64: {}".format(spilling))
    # The Llama path's head dim: local memory is reported, not gated.
    d128 = {"{}{}".format(r["kernel"], "/grad_fp32" if r["grad_fp32"] else ""):
            {key: r[key] for key in ("registers", "local_bytes", "blocks_per_sm")}
            for r in resources if r["D"] == 128 and r["dtype"] == str(torch.bfloat16)}

    # Times at each main path's shape and type (bf16): BERT-base padded,
    # Llama-3-8B causal GQA.
    timed, yardsticks = {}, {}
    for path in MAIN_SHAPES:
        timed[path], yardsticks[path] = time_kernels(path, main[path])
    A.reset_launch_counts()
    llama = MAIN_SHAPES["llama3_8b"]
    emit("kernels", checks=results, resources=resources, bf16_d128_resources=d128,
         shape_main=[BERT_B, BERT_S, 12, 64], dtype=str(torch.bfloat16),
         timed=timed["bert_base"], **yardsticks["bert_base"],
         bert_base_bo={"shape": [64, BERT_S, 12, 64], "timed": timed["bert_base_bo"],
                       **yardsticks["bert_base_bo"]},
         bert_base_lanes={"shape": [4 * BERT_B, BERT_S, 12, 64],
                          "timed": timed["bert_base_lanes"], **yardsticks["bert_base_lanes"]},
         llama3_8b={"shape": [llama[0], llama[1], llama[3], llama[4], llama[5]],
                    "causal": True, "timed": timed["llama3_8b"], **yardsticks["llama3_8b"]})
    return main


def time_kernels(path, main):
    """Times of the three kernels at ``path``'s shape in bf16, written into
    ``main`` beside each one's bound, plain-version time and library time;
    returns (``main`` with the fused dQ's time, yardsticks). BERT-base is
    key-padded and not causal; Llama-3-8B causal, unpadded, GQA 32:8."""
    from maggy_tpu_torch.ops import attention as A

    B, S, _, H, Hkv, D = MAIN_SHAPES[path]
    causal = path == "llama3_8b"
    dtype = torch.bfloat16
    q, k, v, do, mask = make_inputs(B, S, S, H, Hkv, D, dtype, not causal, seed=2)
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
            ms=lambda: A.flash_bwd_dkdv(q, k, v, do, lse, delta, mask, causal),
            plain=lambda: A._plain_bwd_dkdv(q, k, v, do, lse, delta, mask, causal),
            library=None, nbytes=2 * t_q + 4 * t_kv + 2 * stat + mask_b, flops=8 * D * n_live),
        "flash_bwd_dq": dict(
            ms=lambda: A.flash_bwd_dq(q, k, v, do, lse, delta, mask, causal),
            plain=lambda: A._plain_bwd_dq(q, k, v, do, lse, delta, mask, causal),
            library=None, nbytes=3 * t_q + 2 * t_kv + 2 * stat + mask_b, flops=6 * D * n_live),
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


def train_bert_asha(lr, warmup_frac, budget, reporter, out_dir):
    """One trial of the BERT-base ASHA sweep (slice, slice_process)."""
    from maggy_tpu_torch.models import BertEncoder
    from maggy_tpu_torch.train import Trainer, adamw, warmup_cosine_decay_schedule

    record = TrialRecord(out_dir, reporter)
    full_fp32()
    cfg, batch = bert_data()
    total = int(budget) * STEPS_PER_BUDGET
    sched = warmup_cosine_decay_schedule(0.0, lr, int(total * warmup_frac), total)
    trainer = Trainer(BertEncoder(cfg, device="meta"), adamw(sched), labels_loss,
                      device=DEVICE).init(seed=0)
    with record:
        for i in range(total):
            loss = trainer.step(batch(i))
            record.steps += 1
            if i % REPORT_EVERY == REPORT_EVERY - 1 or i == total - 1:
                reporter.broadcast(-loss, step=i)
    final = float(loss)
    if not math.isfinite(final):
        raise FloatingPointError("non-finite loss {}".format(final))
    return {"metric": -final}


def trainer_state(trainer):
    """What a BERT trial checkpoints: the model, AdamW's state and the
    learning-rate schedule's step."""
    return {"model": trainer.model.state_dict(), "optimizer": trainer.optimizer.state_dict(),
            "scheduler": trainer.scheduler.state_dict()}


def train_bert_fork(lr, warmup_frac, budget, reporter, ctx, out_dir):
    """One trial of the slice_fork and slice_resume sweeps: train_bert_asha
    with a checkpoint of its state (and its last loss) at its end, and, for
    a fork, a resume from the staged parent checkpoint at the step after it
    under this trial's own schedule (its larger budget). A fork whose own
    final checkpoint is already in its dir (it trained to its end before an
    interruption, and only its FINAL was lost) restores that one and trains
    no step."""
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


def bert_asha_sweep(exp_dir, pool, train=train_bert_asha):
    """The BERT-base ASHA(3, 1, 9) + median sweep on two runners of
    ``pool``: (result, wall s, records, the driver process's launches)."""
    from maggy_tpu_torch import OptimizationConfig, Searchspace, experiment
    from maggy_tpu_torch.ops import attention as A
    from maggy_tpu_torch.optimizers import Asha

    out_dir = fresh_dir(os.path.join(exp_dir, "records"))
    sp = Searchspace(lr=("DOUBLE_LOG", [1e-5, 1e-3]), warmup_frac=("DOUBLE", [0.0, 0.3]))
    config = OptimizationConfig(
        name="bert_base_asha_smoke", num_trials=9,
        optimizer=Asha(reduction_factor=3, resource_min=1, resource_max=9, seed=0),
        searchspace=sp, direction="max", num_workers=2, es_policy="median",
        es_min=3, hb_interval=0.1, seed=0, experiment_dir=fresh_dir(os.path.join(exp_dir, "exp")),
        pool=pool)
    A.reset_launch_counts()
    t0 = time.perf_counter()
    result = experiment.lagom(functools.partial(train, out_dir=out_dir), config)
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
    result, wall, records, launches = bert_asha_sweep(exp_dir, "thread")
    trials, promoted, total_steps, expected = check_bert_sweep(
        "slice", result, exp_dir, records, launches)
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
         logits_max_abs_err=logit_err, logits_tol=logit_tol,
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
        # The last FINAL's checkpoint GC may still be deleting.
        for t in threading.enumerate():
            if t.name == "fork-gc":
                t.join(120)
    trials, promoted, total_steps, expected = check_bert_sweep(
        "slice_fork", result, exp_dir, records, launches)
    telemetry = journal_check("slice_fork", os.path.join(exp_dir, "exp"), result, trace=True)
    reading = fork_reading(telemetry)
    reading_warm = warm_reading("slice_fork", telemetry, before)
    CAPTURED["bert_base_fork"] = reading_warm["captured"]
    clear_warm()
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
    # retired on disk. The journal holds each retirement but those of the
    # top rung's parents, which happen when the sweep is exhausted and may
    # land after the journal closed.
    (run_dir,) = glob.glob(os.path.join(exp_dir, "exp", "*", ""))
    spent = {t["info_dict"]["parent"] for t in trials if t["info_dict"].get("parent")
             and not by_id[t["info_dict"]["parent"]]["early_stop"]}
    top = {t["info_dict"].get("parent") for t in trials
           if t["params"]["budget"] == RUNG_BUDGETS[-1]}
    on_disk = {tid for tid in spent if os.path.isdir(os.path.join(run_dir, tid, "checkpoints"))}
    if on_disk or not (spent - top) <= gced:
        problems.append("ckpt_gc: spent parents {}, still on disk {}, journaled {}".format(
            sorted(spent), sorted(on_disk), sorted(gced)))
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
        ms, trainer = lanes_step_alone(make, bert_batch)
        profiles[label] = dict(step_device_profile(lambda i: trainer.step(bert_batch(i))),
                               replayed_step_alone_ms=ms)
        del trainer
        eager = make(warm_start=False)
        eager.step(bert_batch(0))
        ops[label] = op_device_ms(lambda i: eager.step(bert_batch(i)))
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
    emit("slice_lanes", phase_s=time.perf_counter() - t_phase,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, speedup=mnist["speedup"],
         problems=problems)
    if problems:
        raise AssertionError("slice_lanes: {}".format("; ".join(problems)))
    return launches


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
    bf16 roundings (2^-8 relative each) of the largest entry, for two
    layers whose residual stream, products and attention probabilities are
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


def phase_slice_llama(exp_dir):
    from maggy_tpu_torch.models import Llama, LlamaConfig
    from maggy_tpu_torch.ops import chunked_next_token_loss
    from maggy_tpu_torch.train import Trainer, adamw, clear_warm, only_lora

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = LlamaConfig.llama3_8b()
    # Token batches over the whole vocabulary, made from a numpy seed.
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, base.vocab_size, size=(4, LLAMA_B, LLAMA_S)), device="cuda")

    def batch(i):
        t = tokens[i % tokens.shape[0]]
        return {"inputs": (t,), "tokens": t}

    def loss_fn(out, b):
        return chunked_next_token_loss(out[0], out[1], b["tokens"])

    def make_trainer(lora_rank, lora_alpha, lr, warm_start=None):
        cfg = dataclasses.replace(LlamaConfig.llama3_8b(lora_rank=int(lora_rank)),
                                  lora_alpha=float(lora_alpha))
        return Trainer(Llama(cfg, device="meta"), only_lora(adamw(lr)), loss_fn,
                       device="cuda", train_kwargs={"return_hidden": True},
                       warm_start=warm_start).init(seed=0), None

    sweep = llama_lora_sweep("slice_llama", "llama3_8b_lora_asha_smoke", exp_dir,
                             make_trainer, batch, base.num_layers)
    result, telemetry, before = sweep["result"], sweep["telemetry"], sweep["before"]
    # The Llama sweep may step eagerly only where a capture raised (out of
    # memory beside the other runner's 8B base, say): then the reason and
    # the peak memory are printed.
    reading_warm = warm_reading("slice_llama", telemetry, before, must_capture=False)
    if not reading_warm["captured"] and not reading_warm["graph_failures"]:
        emit("slice_llama", warm=reading_warm)
        raise AssertionError("slice_llama stepped eagerly without a failed capture: {}".format(
            reading_warm))
    CAPTURED["llama3_8b"] = reading_warm["captured"]
    gc.collect()
    torch.cuda.empty_cache()

    # A 2-layer model at full width on the card (kernels) against the same
    # weights on the CPU (reference attention): hidden states, the chunked
    # loss and the layer-0 adapters' gradients, with the base frozen in bf16
    # as in the sweep and lora_b drawn nonzero so every adapter has one.
    cfg2 = dataclasses.replace(LlamaConfig.llama3_8b(lora_rank=16), num_layers=2)
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
        emit("slice_llama", full_width=full_width)
        raise AssertionError("full-width Llama off the CPU path: {}".format(bad or full_width))

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
    # Then the thread sweep with telemetry off and on in turns, twice: its
    # cost where the host sets the pace, both sides warm.
    pairs = [("thread_telemetry_{}_{}".format("on" if on else "off", i), "thread", on)
             for i in (1, 2) for on in (False, True)]
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


def fresh_dir(path):
    shutil.rmtree(path, ignore_errors=True)
    os.makedirs(path)
    return path


def main():
    from maggy_tpu_torch.train import clear_warm

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
        "bert_base_process": phase_slice_process(
            os.path.join(ROOT, "build", "chip_smoke_experiments_process"), asha_step_ms)}
    clear_warm()
    phase_slice_mnist(os.path.join(ROOT, "build", "chip_smoke_experiments_mnist"))
    phase_slice_recovery(fresh_dir(os.path.join(ROOT, "build", "chip_smoke_experiments_recovery")))
    clear_warm()
    launches["bert_base_fork"] = phase_slice_fork(
        os.path.join(ROOT, "build", "chip_smoke_experiments_fork"), slice_reading)
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
    launches["bert_base_lanes"] = phase_slice_lanes(
        os.path.join(ROOT, "build", "chip_smoke_experiments_lanes"), warm_bert_losses)
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
