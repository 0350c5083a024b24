"""Chip-time goodput ledger: where every held runner-second went.

The operator's first question — *of every chip-second the fleet held, how
many trained the model?* — answered as a pure fold over the journal.
``compute_goodput(events)`` classifies every runner-second between a
partition's registration and the experiment's end into the closed,
vocab-pinned taxonomy ``vocab.GOODPUT_BUCKETS``:

- ``train``    — goodput: inside train_fn, first-run productive steps;
- ``init`` / ``trace`` / ``compile`` — the attributed ttfm phases from the
  runner's ``compiled`` record (telemetry/runnerstats.py);
- ``ckpt_save`` / ``ckpt_restore`` — checkpoint I/O from the runner's
  ``ckpt_saved`` record (the checkpoint-save edge journaled per trial);
- ``fork_stage`` — parent-checkpoint staging (``fork_load_ms``);
- ``rework``   — re-trained compute: a dead attempt's whole duration
  (requeue / runner loss re-runs it) plus the parent-prefix a
  from-scratch promotion re-trains (a fork would have skipped it);
- ``handoff``  — a partition's FINAL -> next-running gap (< the spans.py
  ``HANDOFF_CAP_S`` bound, same cap as the handoff stats);
- ``queue_wait`` — runner registered -> its first trial running;
- ``idle``     — reserved but trial-less (rung barriers, drain, gaps at
  or above the handoff cap);
- ``unaccounted`` — the explicit residual: assigned-but-never-running
  windows and whatever the fold could not attribute. Never silently
  folded into another bucket — bench gates bound it.

Gang-aware: a gang's member partitions mirror the leader attempt's
bucket proportions over the assembled window, so an N-chip trial costs N
chip-seconds per wall second and per-partition bucket sums still equal
held time exactly (``sum(buckets) == held_s`` is a tested identity).

Like everything in spans.py, this is a PURE function over journal
events: the same journal always reproduces the same ledger, live (the
driver's TELEM snapshot / metrics gauges), over RPC, or replayed offline
(``python -m maggy_tpu_torch.telemetry goodput <dir>``, bench's
``detail.goodput``). Multi-source fleet directories merge through
``merge_corrected`` with the sink's per-agent clock offsets first.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from maggy_tpu_torch.telemetry.vocab import GOODPUT_BUCKETS

#: Same bound spans.derive uses for the handoff stats: gaps at/above it
#: are deliberate scheduling idle (rung barriers), below it are hand-off
#: overhead. (spans imports this module lazily, so the top-level import
#: is cycle-free.)
from maggy_tpu_torch.telemetry.spans import HANDOFF_CAP_S

#: compiled-record millisecond field -> badput bucket.
_COMPILE_SUBS = (("init_ms", "init"), ("trace_ms", "trace"),
                 ("compile_ms", "compile"), ("fork_load_ms", "fork_stage"))
#: ckpt_saved-record millisecond field -> badput bucket.
_CKPT_SUBS = (("save_ms", "ckpt_save"), ("restore_ms", "ckpt_restore"))


def _zero() -> Dict[str, float]:
    return {b: 0.0 for b in GOODPUT_BUCKETS}


def _add(into: Dict[str, float], frm: Dict[str, float]) -> None:
    for k, v in frm.items():
        if v:
            into[k] = into.get(k, 0.0) + v


def merge_corrected(events_by_source: Dict[str, List[Dict[str, Any]]],
                    offsets: Optional[Dict[str, Any]] = None
                    ) -> List[Dict[str, Any]]:
    """Merge per-source event lists into one time-ordered stream,
    correcting each source's clock by its estimated offset
    (``corrected_t = t - offset_s`` — the sink's Cristian estimate says
    the source's clock reads ``offset_s`` AHEAD of the fleet host).
    ``offsets`` accepts either ``{source: offset_s}`` floats or the
    fleet replay's ``clock_offsets`` entries (``{source: {"offset_s":
    ...}}``). Sources without an estimate pass through uncorrected."""
    merged: List[Dict[str, Any]] = []
    offsets = offsets or {}
    for source, events in events_by_source.items():
        off = offsets.get(source)
        if isinstance(off, dict):
            off = off.get("offset_s")
        off = float(off or 0.0)
        for ev in events:
            if off and ev.get("t") is not None:
                ev = dict(ev)
                ev["t"] = float(ev["t"]) - off
            merged.append(ev)
    merged.sort(key=lambda e: e.get("t") or 0.0)
    return merged


def compute_goodput(events: List[Dict[str, Any]],
                    handoff_cap_s: float = HANDOFF_CAP_S) -> Dict[str, Any]:
    """The ledger: journal events -> chip-time buckets (pure function).

    Returns ``{}`` for journals with no runner activity; otherwise::

        {"held_chip_s": float,          # sum of per-partition windows
         "buckets": {bucket: seconds},  # sums exactly to held_chip_s
         "goodput_fraction": float,     # train / held
         "unaccounted_fraction": float,
         "badput_top": [{"bucket", "s", "fraction"}, ...],  # top 3
         "per_partition": {pid: {"held_s", "buckets",
                                 "goodput_fraction"}},
         "per_trial": {tid: {bucket: seconds}},  # nonzero only
         "partition_samples": {pid: [[t, cumulative_fraction], ...]}}
    """
    # ---------------------------------------------------------- pass 1
    reg_t: Dict[int, float] = {}
    exp_end: Optional[float] = None
    # trial -> ordered lifecycle: (t, seq, phase, partition, reason)
    life: Dict[str, List[Tuple[float, int, str, Optional[int],
                               Optional[str]]]] = {}
    assigned: Dict[str, List[Tuple[float, Optional[int]]]] = {}
    compiled: Dict[str, Dict[str, Any]] = {}
    ckpts: Dict[str, Dict[str, Any]] = {}
    parent_of: Dict[str, str] = {}
    block_of: Dict[str, str] = {}
    forked: set = set()
    gangs: List[Dict[str, Any]] = []
    open_gangs: Dict[str, Dict[str, Any]] = {}
    for seq, ev in enumerate(events):
        t = ev.get("t")
        if t is None:
            continue
        t = float(t)
        kind = ev.get("ev")
        phase = ev.get("phase")
        if kind == "runner" and phase == "registered":
            pid = ev.get("partition")
            if pid is not None:
                reg_t.setdefault(int(pid), t)
            continue
        if kind == "experiment" and phase in ("finalized", "end"):
            exp_end = t if exp_end is None else max(exp_end, t)
            continue
        if kind != "trial":
            continue
        trial = ev.get("trial")
        if not trial:
            continue
        pid = ev.get("partition")
        pid = int(pid) if pid is not None else None
        if phase == "queued":
            parent = (ev.get("info") or {}).get("parent")
            if parent is not None:
                parent_of[trial] = parent
        elif phase == "assigned":
            assigned.setdefault(trial, []).append((t, pid))
            if ev.get("block") is not None:
                # Vectorized block lane (config.vmap_lanes): this trial's
                # FIRST attempt shares one chip with its block siblings.
                block_of[trial] = ev["block"]
        elif phase in ("running", "finalized", "preempted", "requeued",
                       "lost"):
            life.setdefault(trial, []).append(
                (t, seq, phase, pid, ev.get("reason")))
        elif phase == "compiled":
            compiled.setdefault(trial, dict(ev))
        elif phase == "ckpt_saved":
            ckpts.setdefault(trial, dict(ev))
        elif phase == "forked_from":
            forked.add(trial)
        elif phase == "gang_assembled":
            open_gangs[trial] = {
                "trial": trial, "leader": pid, "t0": t,
                "members": [int(m) for m in (ev.get("members") or [])]}
        elif phase == "gang_released":
            g = open_gangs.pop(trial, None)
            if g is not None:
                g["t1"] = t
                gangs.append(g)
    if not life and not reg_t:
        return {}
    last_life = max((t for seq_l in life.values() for (t, _s, _p, _pid, _r)
                     in seq_l), default=None)
    candidates = [x for x in (exp_end, last_life) if x is not None]
    if not candidates:
        return {}
    t_end = max(candidates)

    # --------------------------------------------------- attempt building
    # An attempt = one [running, terminal] stay of a trial on a partition.
    # finalized / preempted (checkpoint preserved) / requeued with
    # reason=preempted close it productively ("final"); requeued for any
    # other reason and lost close it as a dead attempt whose work is
    # re-trained ("dead" -> rework). A terminal with no open attempt but
    # a fresh preceding assignment marks an assigned-but-never-running
    # window: explicit unaccounted, never silently dropped.
    attempts: List[Dict[str, Any]] = []
    pseudo: List[Tuple[int, float, float]] = []
    for trial, seq_l in life.items():
        seq_l.sort(key=lambda x: (x[0], x[1]))
        marks = sorted(assigned.get(trial, []))
        open_a: Optional[Dict[str, Any]] = None
        n_done = 0
        last_end: Optional[float] = None
        for t, _seq, phase, pid, reason in seq_l:
            if phase == "running":
                if open_a is not None:
                    # Missing terminal (torn journal): close conservatively
                    # as productive at the next dispatch.
                    open_a.update(t1=t, status="final")
                    attempts.append(open_a)
                    last_end = t
                if pid is not None:
                    open_a = {"trial": trial, "pid": pid, "t0": t,
                              "index": n_done}
                    n_done += 1
                continue
            preserved = phase in ("finalized", "preempted") or (
                phase == "requeued" and reason == "preempted")
            if open_a is not None:
                open_a.update(t1=t, status="final" if preserved else "dead")
                attempts.append(open_a)
                open_a = None
                last_end = t
            else:
                hit = None
                for ta, pa in marks:
                    if ta > t:
                        break
                    if pa is not None and (last_end is None
                                           or ta >= last_end):
                        hit = (ta, pa)
                if hit is not None:
                    pseudo.append((hit[1], hit[0], t))
                    last_end = t
        if open_a is not None:
            # Still running at journal end: the remainder trained.
            open_a.update(t1=max(t_end, open_a["t0"]), status="final")
            attempts.append(open_a)

    # ------------------------------------------------------ classification
    per_partition: Dict[int, Dict[str, float]] = {}
    per_trial: Dict[str, Dict[str, float]] = {}
    coverage: Dict[int, List[Tuple[float, float]]] = {}
    samples_src: Dict[int, List[Tuple[float, Dict[str, float]]]] = {}
    trial_train: Dict[str, float] = {}
    carved: Dict[str, float] = {}
    scratch = set(parent_of) - forked
    subs_done: set = set()
    attempts.sort(key=lambda a: a["t0"])
    # Vectorized blocks (config.vmap_lanes > 1): a block's K lanes share
    # ONE chip for the block's window, so each lane attempt carries 1/K
    # of the wall-seconds it spans. Blocks only assemble at fresh
    # dispatch and a requeued lane re-runs scalar, so a lane's FIRST
    # attempt is its block stay — attempts at index 0 of a block-stamped
    # trial split K ways, and once a lane finalizes early (masked) its
    # 1/K share of the remaining block window accrues to ``lane_idle``.
    # Sum over lanes of (live + idle)/K == the block's wall window, so
    # the per-partition closure identity stays exact.
    block_attempts: Dict[str, List[Dict[str, Any]]] = {}
    for a in attempts:
        blk = block_of.get(a["trial"])
        if blk is not None and a["index"] == 0:
            a["vmap_block"] = blk
            block_attempts.setdefault(blk, []).append(a)
    for a in attempts:
        trial, pid = a["trial"], a["pid"]
        t0, t1 = a["t0"], min(a["t1"], t_end)
        dur = max(0.0, t1 - t0)
        bk: Dict[str, float] = {}
        if a["status"] == "dead":  # vocab-ok: internal attempt status, not a journal field
            bk["rework"] = dur
        else:
            subs: Dict[str, float] = {}
            if trial not in subs_done:
                subs_done.add(trial)
                rec = compiled.get(trial) or {}
                for key, bucket in _COMPILE_SUBS:
                    if rec.get(key):
                        subs[bucket] = subs.get(bucket, 0.0) \
                            + float(rec[key]) / 1e3
                rec = ckpts.get(trial) or {}
                for key, bucket in _CKPT_SUBS:
                    if rec.get(key):
                        subs[bucket] = subs.get(bucket, 0.0) \
                            + float(rec[key]) / 1e3
            sub_total = sum(subs.values())
            if sub_total > dur:
                # Measured phases exceed the attempt's wall window (clock
                # skew / sub-ms attempts): scale down, no train remains.
                scale = dur / sub_total if sub_total else 0.0
                subs = {k: v * scale for k, v in subs.items()}
                train = 0.0
            else:
                train = dur - sub_total
            if trial in scratch:
                # From-scratch promotion: it re-trains its parent's
                # prefix before producing new work — a fork would have
                # resumed instead. Carve the parent's measured train
                # time (once per trial) into rework.
                budget = trial_train.get(parent_of[trial], 0.0) \
                    - carved.get(trial, 0.0)
                carve = min(max(0.0, budget), train)
                if carve > 0:
                    train -= carve
                    subs["rework"] = subs.get("rework", 0.0) + carve
                    carved[trial] = carved.get(trial, 0.0) + carve
            trial_train[trial] = trial_train.get(trial, 0.0) + train
            bk = subs
            bk["train"] = bk.get("train", 0.0) + train
        blk = a.get("vmap_block")
        if blk is not None and len(block_attempts[blk]) > 1:
            k = len(block_attempts[blk])
            bk = {key: v / k for key, v in bk.items()}
        a["buckets"] = bk
        _add(per_partition.setdefault(pid, _zero()), bk)
        _add(per_trial.setdefault(trial, {}), bk)
        coverage.setdefault(pid, []).append((t0, t1))
        samples_src.setdefault(pid, []).append((t1, bk))
    # Masked-lane idle: after a lane's own FINAL the block keeps running
    # on the survivors — the retired lane's 1/K share of that tail is
    # badput the masked lane "holds" (``lane_idle``), closing each lane's
    # share at exactly (block_end - block_start) / K.
    for blk, group in block_attempts.items():
        k = len(group)
        if k < 2:
            continue
        t_last = min(max(x["t1"] for x in group), t_end)
        for a in group:
            idle = max(0.0, t_last - min(a["t1"], t_end)) / k
            if idle > 0:
                share = {"lane_idle": idle}
                _add(a["buckets"], share)
                _add(per_partition.setdefault(a["pid"], _zero()), share)
                _add(per_trial.setdefault(a["trial"], {}), share)
    for pid, ta, t1 in pseudo:
        t1 = min(t1, t_end)
        dur = max(0.0, t1 - ta)
        per_partition.setdefault(pid, _zero())["unaccounted"] += dur
        coverage.setdefault(pid, []).append((ta, t1))
    # Gang members mirror the leader attempt's proportions: an N-chip
    # trial costs N chip-seconds per wall second, each member's window
    # classified like the leader's (it ran the same program).
    for g in gangs + list(open_gangs.values()):
        t0, t1 = g["t0"], min(g.get("t1", t_end), t_end)
        if t1 <= t0:
            continue
        leader = g.get("leader")
        lead = next((a for a in attempts
                     if a["trial"] == g["trial"]
                     and a["t1"] >= t0 and a["t0"] <= t1), None)
        lead_bk = (lead or {}).get("buckets") or {}
        total = sum(lead_bk.values())
        for m in g["members"]:
            if m == leader:
                continue
            dur = t1 - t0
            if total > 0:
                bk = {k: v / total * dur for k, v in lead_bk.items()}
            else:
                bk = {"idle": dur}
            _add(per_partition.setdefault(m, _zero()), bk)
            _add(per_trial.setdefault(g["trial"], {}), bk)
            coverage.setdefault(m, []).append((t0, t1))

    # ------------------------------------------- gaps + residual closure
    fleet = _zero()
    held_total = 0.0
    per_partition_out: Dict[int, Dict[str, Any]] = {}
    samples: Dict[int, List[List[float]]] = {}
    for pid in sorted(set(per_partition) | set(reg_t)):
        bk = per_partition.get(pid) or _zero()
        cov = sorted(coverage.get(pid, []))
        starts = [s for s, _e in cov]
        h0_candidates = [x for x in [reg_t.get(pid)] + starts
                         if x is not None]
        if not h0_candidates:
            continue
        h0 = min(h0_candidates)
        held = max(0.0, t_end - h0)
        # Complement of the merged coverage: leading gap = queue_wait
        # (registered, waiting for the first trial), interior gaps split
        # handoff/idle on the spans.py cap, trailing = idle (drain).
        prev = h0
        first_gap = True
        for s, e in cov:
            s, e = max(s, h0), min(e, t_end)
            if s > prev:
                gap = s - prev
                if first_gap:
                    bk["queue_wait"] += gap
                elif gap < handoff_cap_s:
                    bk["handoff"] += gap
                else:
                    bk["idle"] += gap
            if e > prev or s > prev:
                first_gap = False
            prev = max(prev, e)
        if prev < t_end:
            bk["idle"] += t_end - prev
        # Exact closure: whatever remains (overlapping attempts, float
        # dust) is unaccounted — sum(buckets) == held is an identity the
        # tests pin, so drift is visible instead of silently absorbed.
        bk["unaccounted"] += held - sum(bk.values())
        held_total += held
        _add(fleet, bk)
        per_partition_out[pid] = {
            "held_s": held, "buckets": bk,
            "goodput_fraction": round(bk["train"] / held, 4)
            if held > 0 else None}
        cum = 0.0
        pts: List[List[float]] = []
        for t1, abk in sorted(samples_src.get(pid, []),
                              key=lambda x: x[0]):
            cum += abk.get("train", 0.0)
            if t1 > h0:
                pts.append([round(t1, 3), round(cum / (t1 - h0), 4)])
        if pts:
            samples[pid] = pts
    if held_total <= 0:
        return {}
    badput = sorted(((b, s) for b, s in fleet.items()
                     if b != "train" and s > 0),
                    key=lambda x: -x[1])[:3]
    return {
        "held_chip_s": held_total,
        "buckets": fleet,
        "goodput_fraction": round(fleet["train"] / held_total, 4),
        "unaccounted_fraction": round(fleet["unaccounted"] / held_total, 4),
        "badput_top": [{"bucket": b, "s": round(s, 3),
                        "fraction": round(s / held_total, 4)}
                       for b, s in badput],
        "per_partition": per_partition_out,
        "per_trial": {tid: {k: v for k, v in bk.items() if v}
                      for tid, bk in per_trial.items()},
        "partition_samples": samples,
    }


def render_goodput(block: Dict[str, Any]) -> List[str]:
    """Human-readable ledger lines (monitor --goodput / CLI output)."""
    if not block:
        return ["goodput: no runner activity in journal"]
    lines = ["goodput: {:.1%} of {:.1f} held chip-seconds".format(
        block.get("goodput_fraction") or 0.0,
        block.get("held_chip_s") or 0.0)]
    for item in block.get("badput_top") or []:
        lines.append("  badput {:<12} {:>8.1f}s  ({:.1%})".format(
            item["bucket"], item["s"], item["fraction"]))
    lines.append("  unaccounted  {:.1%}".format(
        block.get("unaccounted_fraction") or 0.0))
    for pid, p in sorted((block.get("per_partition") or {}).items()):
        lines.append("  p{:<3} {:>7.1f}s held, goodput {}".format(
            pid, p.get("held_s") or 0.0,
            "{:.1%}".format(p["goodput_fraction"])
            if p.get("goodput_fraction") is not None else "n/a"))
    return lines


__all__ = ["compute_goodput", "merge_corrected", "render_goodput",
           "GOODPUT_BUCKETS", "HANDOFF_CAP_S"]
