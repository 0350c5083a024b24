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
             through the kernels. Then the swept model's logits against the
             same weights on the CPU path, the per-step time alone, and a
             torch.profiler breakdown of five more steps (with each flash
             kernel's device time per launch).
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

Then the {"kernels": [...]} summary line (one entry per kernel and main
path, each with that path's launches and times at its shape), the
nvidia-smi line, and the last
line {"ok": true, "device": {...}}. Needs one CUDA card; imports nothing of
JAX or maggy_tpu.
"""

from __future__ import annotations

import copy
import dataclasses
import gc
import json
import math
import os
import re
import shutil
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
               "llama3_8b": (LLAMA_B, LLAMA_S, LLAMA_S, 32, 8, 128)}


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
    return (torch.as_tensor(tokens, device="cuda"), torch.as_tensor(mask, device="cuda"),
            torch.as_tensor(labels.astype(np.int64), device="cuda"))


def phase_slice(exp_dir):
    from maggy_tpu_torch import OptimizationConfig, Searchspace, experiment
    from maggy_tpu_torch.models import BertConfig, BertEncoder
    from maggy_tpu_torch.ops import attention as A
    from maggy_tpu_torch.optimizers import Asha
    from maggy_tpu_torch.train import (Trainer, adamw, cross_entropy_loss,
                                       warmup_cosine_decay_schedule)

    cfg = BertConfig.base()
    tokens, mask, labels = make_dataset(cfg.vocab_size, 16, seed=0)
    n_batches = tokens.shape[0] // BERT_B
    lock = threading.Lock()
    steps_taken = []
    step_ms = []

    def batch(i):
        lo = (i % n_batches) * BERT_B
        return {"inputs": (tokens[lo:lo + BERT_B], mask[lo:lo + BERT_B]),
                "labels": labels[lo:lo + BERT_B]}

    def loss_fn(logits, b):
        return cross_entropy_loss(logits, b["labels"])

    def train_bert(lr, warmup_frac, budget, reporter):
        total = int(budget) * STEPS_PER_BUDGET
        sched = warmup_cosine_decay_schedule(0.0, lr, int(total * warmup_frac), total)
        trainer = Trainer(BertEncoder(cfg, device="cuda"), adamw(sched), loss_fn,
                          device="cuda").init(seed=0)
        done = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            for i in range(total):
                loss = trainer.step(batch(i))
                done += 1
                if i % REPORT_EVERY == REPORT_EVERY - 1 or i == total - 1:
                    reporter.broadcast(-loss, step=i)
        finally:
            torch.cuda.synchronize()
            with lock:
                steps_taken.append(done)
                step_ms.append((time.perf_counter() - t0) * 1e3 / max(done, 1))
        final = float(loss)
        if not math.isfinite(final):
            raise FloatingPointError("non-finite loss {}".format(final))
        return {"metric": -final}

    sp = Searchspace(lr=("DOUBLE_LOG", [1e-5, 1e-3]), warmup_frac=("DOUBLE", [0.0, 0.3]))
    config = OptimizationConfig(
        name="bert_base_asha_smoke", num_trials=9,
        optimizer=Asha(reduction_factor=3, resource_min=1, resource_max=9, seed=0),
        searchspace=sp, direction="max", num_workers=2, es_policy="median",
        es_min=3, hb_interval=0.1, seed=0, experiment_dir=exp_dir)

    A.reset_launch_counts()
    t0 = time.perf_counter()
    result = experiment.lagom(train_bert, config)
    wall = time.perf_counter() - t0
    launches = A.launch_counts()

    trials = read_trials(exp_dir)
    promoted = sum(1 for t in trials if t["info_dict"].get("sample_type") == "promoted")
    total_steps = sum(steps_taken)
    expected = cfg.num_layers * total_steps
    if not (len(trials) == result["num_trials"] > 0 and promoted > 0
            and math.isfinite(result["best_val"])):
        raise AssertionError("sweep result malformed: {} trials, {} promoted, {}".format(
            len(trials), promoted, result))
    if any(n != expected for n in launches.values()) or expected == 0:
        raise AssertionError("launches {} != {} layers x {} steps".format(
            launches, cfg.num_layers, total_steps))

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

    # Per-step time of one trainer alone on the card.
    trainer = Trainer(model, adamw(1e-4), loss_fn, device="cuda").init(seed=0)
    for i in range(3):
        trainer.step(batch(i))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    n_alone = 10
    for i in range(n_alone):
        trainer.step(batch(i))
    torch.cuda.synchronize()
    alone_ms = (time.perf_counter() - t1) * 1e3 / n_alone
    profile = step_device_profile(lambda i: trainer.step(batch(i)))

    emit("slice", trials_finished=len(trials), promoted=promoted,
         early_stopped=result["early_stopped"], best_hp=result["best_hp"],
         best_val=result["best_val"], steps=total_steps, launches=launches,
         expected_launches_each=expected, sweep_wall_s=wall,
         step_ms_in_sweep_median=float(np.median(step_ms)),
         step_ms_alone=alone_ms, step_profile=profile,
         pipeline=pipeline_summary(result["pipeline"]), logits_max_abs_err=logit_err,
         logits_tol=logit_tol, peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    return launches, float(np.median(step_ms))


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
    from maggy_tpu_torch.train import (Trainer, adamw, cross_entropy_loss,
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
        trainer = Trainer(BertEncoder(cfg, device="cuda"), adamw(sched), loss_fn,
                          device="cuda").init(seed=0)
        done = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            for i in range(total):
                loss = trainer.step(make_batch(i, size))
                done += 1
                if i % BO_REPORT_EVERY == BO_REPORT_EVERY - 1 or i == total - 1:
                    reporter.broadcast(-loss, step=i)
        finally:
            torch.cuda.synchronize()
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
        A.reset_launch_counts()
        t0 = time.perf_counter()
        result = experiment.lagom(train_bert, config)
        wall = time.perf_counter() - t0
        launches = A.launch_counts()
        trials = read_trials(exp_dir)
        pipe = result["pipeline"]
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
            **pipeline_summary(pipe)}
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

    emit("slice_bo", sweeps=list(out), launches=launches_all,
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


def phase_slice_llama(exp_dir):
    from maggy_tpu_torch import OptimizationConfig, Searchspace, experiment
    from maggy_tpu_torch.models import Llama, LlamaConfig
    from maggy_tpu_torch.ops import attention as A
    from maggy_tpu_torch.ops import chunked_next_token_loss
    from maggy_tpu_torch.optimizers import Asha
    from maggy_tpu_torch.train import Trainer, adamw, only_lora

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = LlamaConfig.llama3_8b()
    # Token batches over the whole vocabulary, made from a numpy seed.
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, base.vocab_size, size=(4, LLAMA_B, LLAMA_S)), device="cuda")
    lock = threading.Lock()
    steps_taken, step_ms = [], []

    def batch(i):
        t = tokens[i % tokens.shape[0]]
        return {"inputs": (t,), "tokens": t}

    def loss_fn(out, b):
        return chunked_next_token_loss(out[0], out[1], b["tokens"])

    def make_trainer(lora_rank, lora_alpha, lr):
        cfg = dataclasses.replace(LlamaConfig.llama3_8b(lora_rank=int(lora_rank)),
                                  lora_alpha=float(lora_alpha))
        return Trainer(Llama(cfg, device="cuda"), only_lora(adamw(lr)), loss_fn,
                       device="cuda", train_kwargs={"return_hidden": True}).init(seed=0)

    def train_llama(lora_rank, lora_alpha, lr, budget, reporter):
        trainer = make_trainer(lora_rank, lora_alpha, lr)
        total = int(budget) * LLAMA_STEPS_PER_BUDGET
        done = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            for i in range(total):
                loss = trainer.step(batch(i))
                done += 1
                reporter.broadcast(-loss, step=i)
        finally:
            torch.cuda.synchronize()
            with lock:
                steps_taken.append(done)
                step_ms.append((time.perf_counter() - t0) * 1e3 / max(done, 1))
        final = float(loss)
        if not math.isfinite(final):
            raise FloatingPointError("non-finite loss {}".format(final))
        return {"metric": -final}

    # The search space of examples/llama_lora_sweep.py.
    sp = Searchspace(lora_rank=("DISCRETE", [4, 8, 16]), lora_alpha=("DOUBLE", [4.0, 32.0]),
                     lr=("DOUBLE", [1e-4, 3e-3]))
    config = OptimizationConfig(
        name="llama3_8b_lora_asha_smoke", num_trials=3,
        optimizer=Asha(reduction_factor=3, resource_min=1, resource_max=3, seed=0),
        searchspace=sp, direction="max", num_workers=2, es_policy="none",
        hb_interval=0.1, seed=0, experiment_dir=exp_dir)

    A.reset_launch_counts()
    t0 = time.perf_counter()
    result = experiment.lagom(train_llama, config)
    wall = time.perf_counter() - t0
    launches = A.launch_counts()
    peak_sweep = torch.cuda.max_memory_allocated()

    trials = read_trials(exp_dir)
    promoted = sum(1 for t in trials if t["info_dict"].get("sample_type") == "promoted")
    finished = [t for t in trials if t["final_metric"] is not None
                and math.isfinite(t["final_metric"])]
    total_steps = sum(steps_taken)
    layers = base.num_layers
    expected = {"flash_fwd": 2 * layers * total_steps, "flash_bwd_dkdv": layers * total_steps,
                "flash_bwd_dq": layers * total_steps}
    if not (len(trials) == len(finished) == result["num_trials"] == 4 and promoted == 1
            and total_steps == 12 and math.isfinite(result["best_val"])):
        raise AssertionError("Llama sweep malformed: {} trials ({} finished, {} promoted), "
                             "{} steps, {}".format(len(trials), len(finished), promoted,
                                                   total_steps, result))
    if launches != expected:
        raise AssertionError("launches {} != {} (remat: the forward twice per layer and "
                             "step)".format(launches, expected))
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

    # Per-step time of one trainer alone on the card, then three profiled
    # steps.
    trainer = make_trainer(16, 16.0, 1e-4)
    for i in range(2):
        trainer.step(batch(i))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    n_alone = 3
    for i in range(n_alone):
        trainer.step(batch(i))
    torch.cuda.synchronize()
    alone_ms = (time.perf_counter() - t1) * 1e3 / n_alone
    profile = step_device_profile(lambda i: trainer.step(batch(i)), steps=3)

    emit("slice_llama", trials_finished=len(finished), promoted=promoted,
         best_hp=result["best_hp"], best_val=result["best_val"], steps=total_steps,
         launches=launches, expected_launches=expected, sweep_wall_s=wall,
         step_ms_in_sweep_median=float(np.median(step_ms)), step_ms_alone=alone_ms,
         step_profile=profile, pipeline=pipeline_summary(result["pipeline"]),
         full_width=full_width, chunked_loss_ms=loss_ms,
         mm_out_dtype_differentiable=mm_out_dtype_differentiable,
         peak_mem_sweep_gb=peak_sweep / 1e9,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
         phase_s=time.perf_counter() - t_phase)
    return launches


def fresh_dir(path):
    os.makedirs(path, exist_ok=True)
    for run in os.listdir(path):
        shutil.rmtree(os.path.join(path, run), ignore_errors=True)
    return path


def main():
    smi = phase_device()
    phase_build()
    main_times = phase_kernels()
    bert_launches, asha_step_ms = phase_slice(
        fresh_dir(os.path.join(ROOT, "build", "chip_smoke_experiments")))
    launches = {
        "bert_base": bert_launches,
        "bert_base_bo": phase_slice_bo(os.path.join(ROOT, "build", "chip_smoke_experiments_bo"),
                                       asha_step_ms),
        "llama3_8b": phase_slice_llama(
            fresh_dir(os.path.join(ROOT, "build", "chip_smoke_experiments_llama")))}
    kernels = [{"name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES[name],
                "path": path, "launches": launches[path][name], **main_times[path][name]}
               for path in MAIN_SHAPES for name in REPLACES]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                            "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
