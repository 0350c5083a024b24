"""Timeline export: telemetry journal -> Chrome-trace-event / Perfetto JSON.

The port's copy of ``maggy_tpu/telemetry/trace.py`` (``build_trace``,
``build_fleet_trace``, ``build_unified_trace``, ``validate_trace``,
``write_trace``).

``python -m maggy_tpu_torch.telemetry trace <exp_dir>`` converts any telemetry
journal into the JSON object format chrome://tracing and https://ui.perfetto.dev
load natively — so the paper's scheduling claim is literally *visible*:
one track per partition, each trial a slice, and the hand-off gap between
one trial's ``finalized`` and the same runner's next ``running`` an actual
visible gap between slices.

Mapping:

- **tracks**: one trace "process" per partition (``pid = partition + 1``,
  named via process_name metadata) plus a ``driver`` track (``pid = 0``)
  for events with no partition attribution (queued, stop_flagged,
  experiment lifecycle).
- **trial slices**: per run attempt (a requeued trial re-runs as a new
  slice on its new partition), an outer ``X`` slice from ``assigned`` to
  the attempt's terminal event, with nested phase sub-slices:
  ``dispatch`` (assigned → running), ``startup`` (running → first_metric;
  the compile stall made visible), ``train`` (first_metric → finalized).
- **instant events**: STOP flags (``stop_flagged`` / ``stop_sent``),
  ``requeued`` / ``lost`` edges, chaos injections (``chaos:<kind>``), and
  health findings (``health:<check>``).
- **counters**: runner-stats memory/RTT samples become ``C`` counter
  events per partition (``rss_mb``, ``hb_rtt_ms``), so a leaking trial is
  a visibly climbing line under its track.
- **gang lanes**: an assembled gang (``gang_assembled`` →
  ``gang_released``) renders one identical slice on every member
  partition's ``gang`` lane, so an N-chip gang is a grouped band across N
  contiguous partition tracks; placer decisions (``pack`` events —
  reserve/stall/release) are instant markers on the driver track.
- **vmap lanes**: a vectorized block's K lane trials (``config.
  vmap_lanes``; lane-stamped ``assigned``/``running``/``finalized``
  edges) each render on their own ``lane <i>`` sub-track under the
  shared partition, so the block is a stack of K parallel trial slices
  and a masked lane's early FINAL is a visibly shorter slice — the
  ``lane_idle`` tail the goodput ledger charges is the empty space to
  the block's right edge.

The exporter is pure (events in, dict out) and the journal is the only
input — any soak/bench artifact can be rendered after the fact.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

#: pid of the driver track; partition p maps to pid p + 1.
DRIVER_PID = 0

#: Phase pairs rendered as nested sub-slices inside a trial slice.
_SUB_SLICES = (
    ("dispatch", "assigned", "running"),
    ("startup", "running", "first_metric"),
    ("train", "first_metric", "finalized"),
)

#: Trial phases rendered as instant markers rather than slice edges.
#: ``suggested`` lands on the driver track (no partition yet): the visible
#: distance to the same trial's ``running`` IS the prefetch lead time;
#: ``prefetch_hit``/``prefetch_miss`` mark each hand-off's path on the
#: partition track.
_INSTANT_PHASES = ("suggested", "queued", "stop_flagged", "stop_sent",
                   "requeued", "lost", "profile_skipped", "prefetch_hit",
                   "prefetch_miss", "preempt_requested", "preempted",
                   "resumed", "gang_assembled", "gang_released",
                   "forked_from")

#: tid of the per-partition gang lane: a gang trial's busy interval is
#: rendered as one slice on EVERY member partition's gang lane, so the
#: assembled block is visible as a grouped band across the contiguous
#: partition tracks (the trial's own slice stays on the leader's tid 0).
GANG_TID = 1

#: tid base of the per-partition vmap lane sub-tracks: a vectorized
#: block's lane ``i`` trial renders on tid ``LANE_TID_BASE + i`` under
#: its partition's process, so the K lanes stack as parallel sub-tracks
#: (scalar trials stay on tid 0; gang lane is tid 1).
LANE_TID_BASE = 100

#: ttfm-breakdown fields of a ``compiled`` event, rendered (in runtime
#: order) as sequential sub-slices inside the attempt's ``startup`` window
#: — the compile stall decomposed: sharded init, jaxpr trace, XLA compile,
#: then the residual first steps' execution.
_COMPILE_SLICES = (("init", "init_ms"), ("trace", "trace_ms"),
                   ("compile", "compile_ms"), ("first_step",
                                               "first_step_ms"))


def _pid(partition: Optional[int]) -> int:
    return DRIVER_PID if partition is None else int(partition) + 1


def build_trace(events: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Pure journal-events -> Chrome-trace dict (``{"traceEvents": [...]}``,
    timestamps in microseconds relative to the first event)."""
    times = [e["t"] for e in events if isinstance(e.get("t"), (int, float))]
    t0 = min(times) if times else 0.0

    def us(t: float) -> int:
        return int(round((t - t0) * 1e6))

    out: List[Dict[str, Any]] = []
    partitions = set()
    by_trial: Dict[str, List[Dict[str, Any]]] = {}
    for ev in events:
        kind = ev.get("ev")
        t = ev.get("t")
        if not isinstance(t, (int, float)):
            continue
        pid = ev.get("partition")
        if pid is not None:
            partitions.add(int(pid))
        if kind == "trial" and ev.get("trial") is not None:
            by_trial.setdefault(ev["trial"], []).append(ev)
        elif kind == "chaos":
            out.append({"name": "chaos:{}".format(ev.get("kind")),
                        "cat": "chaos", "ph": "i", "s": "t",
                        "ts": us(t), "pid": _pid(pid), "tid": 0,
                        "args": {k: v for k, v in ev.items()
                                 if k not in ("ev", "t")}})
        elif kind == "health":
            out.append({"name": "health:{}".format(ev.get("check")),
                        "cat": "health", "ph": "i", "s": "t",
                        "ts": us(t), "pid": _pid(pid), "tid": 0,
                        "args": {k: v for k, v in ev.items()
                                 if k not in ("ev", "t", "stacks")}})
        elif kind == "pack":
            # Placer decisions (reserve/stall/release) on the driver
            # track: a fragmentation stall is a visible marker exactly
            # where the timeline shows scattered free chips.
            out.append({"name": "pack:{}".format(ev.get("op")),
                        "cat": "pack", "ph": "i", "s": "p",
                        "ts": us(t), "pid": DRIVER_PID, "tid": 0,
                        "args": {k: v for k, v in ev.items()
                                 if k not in ("ev", "t")}})
        elif kind == "runner_stats" and pid is not None:
            for counter in ("rss_mb", "hb_rtt_ms"):
                if ev.get(counter) is not None:
                    out.append({"name": counter, "cat": "runner",
                                "ph": "C", "ts": us(t), "pid": _pid(pid),
                                "args": {counter: ev[counter]}})
        elif kind in ("experiment", "runner", "worker", "chaos_armed",
                      "chaos_summary"):
            out.append({"name": "{}:{}".format(kind, ev.get("phase", "")),
                        "cat": "lifecycle", "ph": "i", "s": "p",
                        "ts": us(t), "pid": _pid(pid), "tid": 0,
                        "args": {k: v for k, v in ev.items()
                                 if k not in ("ev", "t")}})

    lane_parts: Dict[int, set] = {}
    for trial_id, evs in by_trial.items():
        evs.sort(key=lambda e: e["t"])
        out.extend(_trial_slices(trial_id, evs, us, lane_parts))
        for ev in evs:
            if ev.get("phase") in _INSTANT_PHASES:
                out.append({"name": "{}:{}".format(ev["phase"],
                                                   trial_id[:8]),
                            "cat": "trial", "ph": "i", "s": "t",
                            "ts": us(ev["t"]),
                            "pid": _pid(ev.get("partition")),
                            "tid": LANE_TID_BASE + int(ev["lane"])
                            if ev.get("lane") is not None else 0,
                            "args": {k: v for k, v in ev.items()
                                     if k not in ("ev", "t")}})

    # Fork genealogy flow arrows (checkpoint-forking search): one
    # Perfetto flow per forked_from edge, from the PARENT's finalized
    # point (the end of its trial slice — where the forked checkpoint
    # was last written) to the CHILD's running edge on its own
    # partition track. Lineage is literally visible: promotion chains
    # render as arrows climbing the rung ladder across runner tracks.
    fork_flows = 0
    fin_point: Dict[str, tuple] = {}
    for trial_id, evs in by_trial.items():
        fin = next((e for e in evs if e.get("phase") == "finalized"), None)
        if fin is not None:
            fin_point[trial_id] = (us(fin["t"]), _pid(fin.get("partition")))
    for trial_id, evs in by_trial.items():
        fork = next((e for e in evs if e.get("phase") == "forked_from"),
                    None)
        if fork is None:
            continue
        src = fin_point.get(fork.get("parent"))
        if src is None:
            continue  # parent finalized outside this journal window
        dst = next((e for e in evs if e.get("phase") == "running"), fork)
        fork_flows += 1
        fid = "fork-{}".format(fork_flows)
        out.append({"name": "fork-flow", "cat": "flow", "ph": "s",
                    "id": fid, "ts": src[0], "pid": src[1], "tid": 0})
        out.append({"name": "fork-flow", "cat": "flow", "ph": "f",
                    "bp": "e", "id": fid, "ts": us(dst["t"]),
                    "pid": _pid(dst.get("partition")), "tid": 0})

    # Gang lanes: each assembled gang renders one slice per MEMBER
    # partition (gang lane, tid GANG_TID) spanning gang_assembled ->
    # gang_released, so an N-chip gang is a grouped band across N
    # contiguous partition tracks — packing (and fragmentation) is
    # literally visible. A journal ending mid-gang closes the band at
    # the last event.
    last_us = max((us(e["t"]) for e in events
                   if isinstance(e.get("t"), (int, float))), default=0)
    gang_parts = set()
    for trial_id, evs in by_trial.items():
        open_gang = None
        for ev in evs:
            phase = ev.get("phase")
            if phase == "gang_assembled":
                open_gang = ev
            elif phase == "gang_released" and open_gang is not None:
                out.extend(_gang_band(trial_id, open_gang, us(ev["t"]),
                                      us, gang_parts))
                open_gang = None
        if open_gang is not None:
            out.extend(_gang_band(trial_id, open_gang, last_us, us,
                                  gang_parts))
    # Idle-held members may never emit an event of their own — their
    # tracks exist because a gang band lands on them.
    partitions |= gang_parts

    # Per-partition goodput-fraction counter tracks: the chip-time
    # ledger's cumulative train/held fraction sampled at each attempt
    # end (telemetry/goodput.py) — utilization drift is a visible line
    # under each partition's track, next to its rss/RTT counters.
    from maggy_tpu_torch.telemetry.goodput import compute_goodput

    gp = compute_goodput(events)
    for p, pts in (gp.get("partition_samples") or {}).items():
        for t, frac in pts:
            out.append({"name": "goodput_fraction", "cat": "goodput",
                        "ph": "C", "ts": us(t), "pid": _pid(int(p)),
                        "args": {"goodput_fraction": frac}})

    # Track naming metadata: driver + one process per partition, sorted so
    # Perfetto lists partition 0..N in order.
    meta = [{"name": "process_name", "ph": "M", "pid": DRIVER_PID, "tid": 0,
             "args": {"name": "driver"}},
            {"name": "process_sort_index", "ph": "M", "pid": DRIVER_PID,
             "tid": 0, "args": {"sort_index": -1}}]
    for p in sorted(partitions):
        meta.append({"name": "process_name", "ph": "M", "pid": _pid(p),
                     "tid": 0, "args": {"name": "partition {}".format(p)}})
        meta.append({"name": "process_sort_index", "ph": "M", "pid": _pid(p),
                     "tid": 0, "args": {"sort_index": p}})
        if p in gang_parts:
            meta.append({"name": "thread_name", "ph": "M", "pid": _pid(p),
                         "tid": GANG_TID, "args": {"name": "gang"}})
            meta.append({"name": "thread_sort_index", "ph": "M",
                         "pid": _pid(p), "tid": GANG_TID,
                         "args": {"sort_index": GANG_TID}})
        for lane in sorted(lane_parts.get(p, ())):
            meta.append({"name": "thread_name", "ph": "M", "pid": _pid(p),
                         "tid": LANE_TID_BASE + lane,
                         "args": {"name": "lane {}".format(lane)}})
            meta.append({"name": "thread_sort_index", "ph": "M",
                         "pid": _pid(p), "tid": LANE_TID_BASE + lane,
                         "args": {"sort_index": LANE_TID_BASE + lane}})
    out.sort(key=lambda e: e.get("ts", 0))
    return {"traceEvents": meta + out, "displayTimeUnit": "ms",
            # The JAX package's source tag, kept so both packages build
            # the same trace from the same journal.
            "otherData": {"source": "maggy_tpu.telemetry",
                          "t0_unix_s": t0,
                          "partitions": sorted(partitions),
                          "trials": len(by_trial),
                          "fork_flows": fork_flows}}


def _gang_band(trial_id: str, assembled: Dict[str, Any], end_us: int,
               us, gang_parts: set) -> List[dict]:
    """One gang's grouped band: an identical slice on every member
    partition's gang lane, from the assembled edge to ``end_us``."""
    out: List[dict] = []
    start = us(assembled["t"])
    members = assembled.get("members") or []
    name = "gang {} x{} ({})".format(
        trial_id[:8], len(members) or "?",
        assembled.get("strategy", "?"))
    args = {"trial": trial_id, "members": list(members),
            "chips": assembled.get("chips"),
            "leader": assembled.get("partition"),
            "strategy": assembled.get("strategy")}
    for m in members:
        gang_parts.add(int(m))
        out.append({"name": name, "cat": "gang", "ph": "X", "ts": start,
                    "dur": max(1, end_us - start), "pid": _pid(int(m)),
                    "tid": GANG_TID, "args": args})
    return out


def _trial_slices(trial_id: str, evs: List[Dict[str, Any]], us,
                  lane_parts: Optional[Dict[int, set]] = None) -> List[dict]:
    """Slices for one trial: one outer slice (+ phase sub-slices) per run
    attempt, split on ``assigned`` occurrences so a requeued trial renders
    as separate slices on each partition it visited. A vectorized block
    lane attempt (lane-stamped edges) lands on its partition's ``lane <i>``
    sub-track (tid ``LANE_TID_BASE + i``) so the block's K trials stack;
    ``lane_parts`` (partition -> lane indices) collects the sub-tracks the
    caller must name."""
    out: List[dict] = []
    attempts: List[List[Dict[str, Any]]] = []
    for ev in evs:
        if ev.get("phase") == "assigned" or not attempts:
            attempts.append([])
        attempts[-1].append(ev)
    for attempt in attempts:
        marks: Dict[str, float] = {}
        partition = None
        terminal = None
        lane = None
        for ev in attempt:
            phase = ev.get("phase")
            if phase not in marks:
                marks[phase] = ev["t"]
            if ev.get("partition") is not None:
                partition = int(ev["partition"])
            if ev.get("lane") is not None:
                lane = int(ev["lane"])
            if phase in ("finalized", "lost") and terminal is None:
                terminal = ev["t"]
        start = marks.get("assigned")
        if start is None or partition is None:
            continue
        end = terminal if terminal is not None else attempt[-1]["t"]
        if end < start:
            continue
        tid = 0
        if lane is not None:
            tid = LANE_TID_BASE + lane
            if lane_parts is not None:
                lane_parts.setdefault(partition, set()).add(lane)
        args = {"trial": trial_id}
        final = next((e for e in attempt if e.get("phase") == "finalized"),
                     None)
        if final is not None:
            args.update({k: final[k] for k in ("early_stop", "error", "span",
                                               "lane", "block")
                         if final.get(k) is not None})
        out.append({"name": "trial {}".format(trial_id[:8]), "cat": "trial",
                    "ph": "X", "ts": us(start),
                    "dur": max(1, us(end) - us(start)),
                    "pid": _pid(partition), "tid": tid, "args": args})
        for name, p_from, p_to in _SUB_SLICES:
            a, b = marks.get(p_from), marks.get(p_to)
            if a is None or b is None or b < a:
                continue
            out.append({"name": name, "cat": "phase", "ph": "X",
                        "ts": us(a), "dur": max(1, us(b) - us(a)),
                        "pid": _pid(partition), "tid": tid,
                        "args": {"trial": trial_id}})
        # Runner-attributed ttfm breakdown: the compiled event carries
        # DURATIONS (runner clock), so the sub-slices are laid out
        # sequentially from the attempt's running edge — driver/runner
        # clock skew shifts the anchor, never the widths.
        compiled = next((e for e in attempt
                         if e.get("phase") == "compiled"), None)
        anchor = marks.get("running")
        if compiled is not None and anchor is not None:
            cursor = us(anchor)
            warm_tag = "warm" if compiled.get("warm") else "cold"
            for name, key in _COMPILE_SLICES:
                ms = compiled.get(key)
                if not ms or ms <= 0:
                    continue
                dur = max(1, int(round(ms * 1e3)))
                out.append({"name": "{} ({})".format(name, warm_tag),
                            "cat": "compile", "ph": "X", "ts": cursor,
                            "dur": dur, "pid": _pid(partition), "tid": tid,
                            "args": {"trial": trial_id, key: ms,
                                     "warm": bool(compiled.get("warm"))}})
                cursor += dur
    return out


def build_fleet_trace(fleet_events: List[Dict[str, Any]],
                      experiments: Dict[str, List[Dict[str, Any]]]
                      ) -> Dict[str, Any]:
    """Fleet timeline: one trace process per FLEET RUNNER, with one
    thread lane per experiment inside it — so multiplexing is literally
    visible: runner 0's track shows experiment A's trial slices on A's
    lane giving way to B's after a preemption marker.

    ``fleet_events`` is the fleet journal (lease/preempt/lifecycle);
    ``experiments`` maps experiment name -> that experiment's own
    telemetry journal events. Experiment-journal partitions are
    per-experiment slot ids, so each trial slice is placed on the fleet
    runner whose lease of (experiment, slot) covers the slice's time —
    slices with no covering lease (driver-side edges) land on the driver
    track."""
    all_events = list(fleet_events)
    for evs in experiments.values():
        all_events.extend(evs)
    times = [e["t"] for e in all_events
             if isinstance(e.get("t"), (int, float))]
    t0 = min(times) if times else 0.0

    def us(t: float) -> int:
        return int(round((t - t0) * 1e6))

    exp_names = sorted(experiments)
    exp_tid = {name: i + 1 for i, name in enumerate(exp_names)}

    # Lease intervals per (exp, slot pid): [(start_us, end_us, runner)].
    leases: Dict[tuple, List[tuple]] = {}
    open_leases: Dict[tuple, tuple] = {}
    out: List[Dict[str, Any]] = []
    runners = set()
    max_us = max((us(t) for t in times), default=0)
    for ev in fleet_events:
        t = ev.get("t")
        if not isinstance(t, (int, float)):
            continue
        kind = ev.get("ev")
        if kind == "lease":
            key = (ev.get("exp"), ev.get("pid"))
            runner = ev.get("runner")
            if runner is not None:
                runners.add(int(runner))
            if ev.get("phase") == "start":
                open_leases[key] = (us(t), runner)
            elif ev.get("phase") == "end":
                started = open_leases.pop(key, None)
                if started is not None:
                    leases.setdefault(key, []).append(
                        (started[0], us(t), started[1]))
        elif kind == "preempt":
            out.append({"name": "preempt:{}".format(ev.get("exp")),
                        "cat": "fleet", "ph": "i", "s": "g", "ts": us(t),
                        "pid": DRIVER_PID, "tid": 0,
                        "args": {k: v for k, v in ev.items()
                                 if k not in ("ev", "t")}})
        elif kind in ("fleet", "fleet_submit", "fleet_admit",
                      "fleet_experiment"):
            out.append({"name": "{}:{}".format(
                            kind, ev.get("exp", ev.get("phase", ""))),
                        "cat": "fleet", "ph": "i", "s": "p", "ts": us(t),
                        "pid": DRIVER_PID, "tid": 0,
                        "args": {k: v for k, v in ev.items()
                                 if k not in ("ev", "t")}})
    for key, (start, runner) in open_leases.items():  # journal ended mid-lease
        leases.setdefault(key, []).append((start, max_us, runner))

    def runner_at(exp: str, slot: int, ts: int):
        for start, end, runner in leases.get((exp, slot), []):
            if start <= ts <= end and runner is not None:
                return int(runner)
        return None

    # Lease slices on each runner track, in the owning experiment's lane.
    for (exp, slot), intervals in leases.items():
        tid = exp_tid.get(exp, 0)
        for start, end, runner in intervals:
            if runner is None:
                continue
            out.append({"name": "lease {}".format(exp), "cat": "lease",
                        "ph": "X", "ts": start,
                        "dur": max(1, end - start),
                        "pid": int(runner) + 1, "tid": tid,
                        "args": {"exp": exp, "slot": slot}})

    # Trial slices from each experiment's journal, remapped from its slot
    # ids onto the fleet runner serving that slot at the slice's time.
    for name, evs in experiments.items():
        tid = exp_tid[name]
        by_trial: Dict[str, List[Dict[str, Any]]] = {}
        for ev in evs:
            if ev.get("ev") == "trial" and ev.get("trial") is not None \
                    and isinstance(ev.get("t"), (int, float)):
                by_trial.setdefault(ev["trial"], []).append(ev)
        for trial_id, tevs in by_trial.items():
            tevs.sort(key=lambda e: e["t"])
            for s in _trial_slices(trial_id, tevs, us):
                slot = s["pid"] - 1  # _pid() inverse
                runner = runner_at(name, slot, s["ts"]) \
                    if slot >= 0 else None
                s["pid"] = DRIVER_PID if runner is None else runner + 1
                s["tid"] = tid
                s.setdefault("args", {})["exp"] = name
                out.append(s)

    meta = [{"name": "process_name", "ph": "M", "pid": DRIVER_PID, "tid": 0,
             "args": {"name": "fleet"}},
            {"name": "process_sort_index", "ph": "M", "pid": DRIVER_PID,
             "tid": 0, "args": {"sort_index": -1}}]
    for r in sorted(runners):
        meta.append({"name": "process_name", "ph": "M", "pid": r + 1,
                     "tid": 0, "args": {"name": "runner {}".format(r)}})
        meta.append({"name": "process_sort_index", "ph": "M", "pid": r + 1,
                     "tid": 0, "args": {"sort_index": r}})
        for name in exp_names:
            meta.append({"name": "thread_name", "ph": "M", "pid": r + 1,
                         "tid": exp_tid[name],
                         "args": {"name": "exp {}".format(name)}})
            meta.append({"name": "thread_sort_index", "ph": "M",
                         "pid": r + 1, "tid": exp_tid[name],
                         "args": {"sort_index": exp_tid[name]}})
    out.sort(key=lambda e: e.get("ts", 0))
    return {"traceEvents": meta + out, "displayTimeUnit": "ms",
            "otherData": {"source": "maggy_tpu.telemetry(fleet)",
                          "t0_unix_s": t0,
                          "runners": sorted(runners),
                          "experiments": exp_names}}


def validate_trace(trace: Dict[str, Any]) -> int:
    """Sanity-check a trace dict is loadable Chrome-trace JSON: a
    ``traceEvents`` list whose entries carry the mandatory keys. Returns
    the event count; raises ValueError otherwise. bench.py runs this on
    the emitted file before recording its path as an artifact."""
    events = trace.get("traceEvents") if isinstance(trace, dict) else None
    if not isinstance(events, list) or not events:
        raise ValueError("not a Chrome trace: missing/empty traceEvents")
    if all(ev.get("ph") == "M" for ev in events if isinstance(ev, dict)):
        raise ValueError("trace carries only metadata — the journal had "
                         "no renderable events")
    for ev in events:
        if not isinstance(ev, dict) or "ph" not in ev or "pid" not in ev:
            raise ValueError("malformed trace event: {!r}".format(ev))
        if ev["ph"] in ("X", "i", "C") and "ts" not in ev:
            raise ValueError("trace event without ts: {!r}".format(ev))
    json.dumps(trace)  # must be pure-JSON serializable
    return len(events)


#: tid of the per-agent execution lane inside an agent's process group
#: (their trial slices render on the per-experiment lanes, like thread
#: runners; this lane carries the agent's OWN journal: lease..done exec
#: slices, clock_offset / sink degradation instants).
AGENT_LANE_TID = 999


def build_unified_trace(fleet_events: List[Dict[str, Any]],
                        experiments: Dict[str, List[Dict[str, Any]]],
                        agent_journals: Optional[Dict[str, List[Dict[str,
                                                                     Any]]]]
                        = None,
                        offsets: Optional[Dict[str, float]] = None
                        ) -> Dict[str, Any]:
    """ONE Perfetto trace for the whole fleet: the fleet timeline
    (``build_fleet_trace`` — driver track, one process per runner with a
    lane per experiment) EXTENDED with the cross-process telemetry the
    journal sink fans in:

    - runner process groups held by REMOTE AGENTS are renamed
      ``agent <id> @host`` (from the fleet journal's ``agent`` join
      events), so each agent process is its own group;
    - each agent's OWN journal (sink segment or surviving local
      ``agent.jsonl``) renders on the agent's execution lane, with every
      timestamp corrected onto the FLEET clock by the agent's journaled
      ``clock_offset`` (``offsets`` overrides per agent; an agent event
      at agent-clock ``t`` happened at fleet-clock ``t - offset_s``);
    - FLOW ARROWS follow each remotely-leased trial across the process
      boundary: ABIND dispatch (driver track) -> the agent-side
      execution slice -> the trial's FINAL — the Perfetto ``s``/``t``/
      ``f`` flow triple, one per delivered lease.

    Pure like every function here: journals in, trace dict out.
    """
    agent_journals = agent_journals or {}
    # Agent registry + journaled clock offsets from the fleet journal.
    runner_agent: Dict[int, str] = {}
    agent_runner: Dict[str, int] = {}
    agent_host: Dict[str, str] = {}
    derived_offsets: Dict[str, float] = {}
    for ev in fleet_events:
        kind = ev.get("ev")
        if kind == "agent" and ev.get("phase") == "join" \
                and ev.get("agent") is not None \
                and ev.get("runner") is not None:
            aid = str(ev["agent"])
            runner_agent[int(ev["runner"])] = aid
            agent_runner[aid] = int(ev["runner"])
            agent_host[aid] = str(ev.get("host") or "?")
        elif kind == "clock_offset" and ev.get("agent") \
                and ev.get("offset_s") is not None:
            derived_offsets[str(ev["agent"])] = float(ev["offset_s"])
    offs = dict(derived_offsets)
    offs.update(offsets or {})

    base = build_fleet_trace(fleet_events, experiments)
    out: List[Dict[str, Any]] = base["traceEvents"]
    t0 = base["otherData"]["t0_unix_s"]

    def us(t: float) -> int:
        return int(round((t - t0) * 1e6))

    # Rename agent-held runner process groups (latest join wins — slot
    # reuse after an agent loss keeps the newest identity).
    for ev in out:
        if ev.get("ph") == "M" and ev.get("name") == "process_name" \
                and ev["pid"] - 1 in runner_agent:
            aid = runner_agent[ev["pid"] - 1]
            ev["args"] = {"name": "agent {} @{}".format(
                aid, agent_host.get(aid, "?"))}

    exp_names = sorted(experiments)
    exp_tid = {name: i + 1 for i, name in enumerate(exp_names)}

    # Agent-side lanes: exec slices (lease..done) + instants, clocks
    # corrected onto the fleet time base. exec_index[(aid, exp, pid)] is
    # the ordered list of corrected exec windows, consumed in order by
    # the flow matcher below.
    exec_index: Dict[tuple, List[tuple]] = {}
    for aid, a_events in sorted(agent_journals.items()):
        runner = agent_runner.get(aid)
        if runner is None:
            continue
        pid = runner + 1
        off = offs.get(aid, 0.0)
        open_lease: Optional[Dict[str, Any]] = None
        open_t: Optional[float] = None
        last_t: Optional[float] = None
        out.append({"name": "thread_name", "ph": "M", "pid": pid,
                    "tid": AGENT_LANE_TID,
                    "args": {"name": "agent {}".format(aid)}})
        out.append({"name": "thread_sort_index", "ph": "M", "pid": pid,
                    "tid": AGENT_LANE_TID,
                    "args": {"sort_index": AGENT_LANE_TID}})

        def _close(end_t: float) -> None:
            nonlocal open_lease, open_t
            if open_lease is None or open_t is None:
                return
            key = (aid, open_lease.get("exp"), open_lease.get("pid"))
            exec_index.setdefault(key, []).append((open_t, end_t))
            out.append({"name": "exec {}".format(open_lease.get("exp")),
                        "cat": "agent", "ph": "X", "ts": us(open_t),
                        "dur": max(1, us(end_t) - us(open_t)),
                        "pid": pid, "tid": AGENT_LANE_TID,
                        "args": {"agent": aid,
                                 "exp": open_lease.get("exp"),
                                 "slot": open_lease.get("pid"),
                                 "offset_s": off}})
            open_lease, open_t = None, None

        for ev in sorted((e for e in a_events
                          if isinstance(e.get("t"), (int, float))),
                         key=lambda e: e["t"]):
            t = ev["t"] - off  # agent clock -> fleet clock
            last_t = t
            kind = ev.get("ev")
            if kind == "agent" and ev.get("phase") == "lease":
                _close(t)
                open_lease, open_t = ev, t
            elif kind == "agent" and ev.get("phase") == "done":
                _close(t)
            elif kind in ("clock_offset", "sink_degraded",
                          "sink_recovered", "obs_started"):
                out.append({"name": kind, "cat": "agent", "ph": "i",
                            "s": "t", "ts": us(t), "pid": pid,
                            "tid": AGENT_LANE_TID,
                            "args": {k: v for k, v in ev.items()
                                     if k not in ("ev", "t")}})
        if open_lease is not None and last_t is not None:
            _close(last_t)  # journal ended mid-lease

    # Flow arrows: ABIND dispatch (fleet journal 'agent' lease event,
    # driver track) -> agent-side exec slice -> the trial's FINAL on the
    # runner's experiment lane. Leases match exec windows in delivery
    # order per (agent, exp, slot).
    finals: Dict[tuple, List[float]] = {}
    for name, evs in experiments.items():
        for ev in evs:
            if ev.get("ev") == "trial" and ev.get("phase") == "finalized" \
                    and ev.get("partition") is not None \
                    and isinstance(ev.get("t"), (int, float)):
                finals.setdefault((name, int(ev["partition"])),
                                  []).append(ev["t"])
    for fs in finals.values():
        fs.sort()
    exec_cursor: Dict[tuple, int] = {}
    flows = 0
    for ev in fleet_events:
        if ev.get("ev") != "agent" or ev.get("phase") != "lease" \
                or not isinstance(ev.get("t"), (int, float)):
            continue
        aid = str(ev.get("agent"))
        key = (aid, ev.get("exp"), ev.get("pid"))
        windows = exec_index.get(key) or []
        i = exec_cursor.get(key, 0)
        if i >= len(windows):
            continue
        exec_cursor[key] = i + 1
        exec_start, exec_end = windows[i]
        flows += 1
        fid = "abind-{}".format(flows)
        abind_t = ev["t"]
        pid = agent_runner[aid] + 1
        # Anchor slice on the driver track for the flow start.
        out.append({"name": "abind {}".format(ev.get("exp")),
                    "cat": "fleet", "ph": "X", "ts": us(abind_t),
                    "dur": 1000, "pid": DRIVER_PID, "tid": 0,
                    "args": {"agent": aid, "exp": ev.get("exp"),
                             "slot": ev.get("pid")}})
        out.append({"name": "trial-flow", "cat": "flow", "ph": "s",
                    "id": fid, "ts": us(abind_t), "pid": DRIVER_PID,
                    "tid": 0})
        out.append({"name": "trial-flow", "cat": "flow", "ph": "t",
                    "id": fid, "ts": us(exec_start) + 1, "pid": pid,
                    "tid": AGENT_LANE_TID})
        # The FINAL inside (or just after) the exec window, consumed
        # in order so each lease binds its own trial's FINAL.
        fin_list = finals.get((ev.get("exp"), ev.get("pid"))) or []
        fin = next((t for t in fin_list if exec_start <= t), None)
        if fin is not None:
            fin_list.remove(fin)
            out.append({"name": "trial-flow", "cat": "flow", "ph": "f",
                        "bp": "e", "id": fid, "ts": us(fin), "pid": pid,
                        "tid": exp_tid.get(ev.get("exp"), 0)})

    out.sort(key=lambda e: e.get("ts", 0))
    base["otherData"].update({
        # The JAX package's source tag, as in build_trace.
        "source": "maggy_tpu.telemetry(unified)",
        "agents": sorted(agent_runner),
        "clock_offsets": offs,
        "flows": flows,
    })
    return base


def write_trace(events: List[Dict[str, Any]], out_path: str,
                env=None) -> int:
    """Build, validate, and write the trace. Returns the trace-event
    count."""
    trace = build_trace(events)
    n = validate_trace(trace)
    payload = json.dumps(trace)
    if env is not None:
        env.dump(payload, out_path)
    else:
        with open(out_path, "w") as f:
            f.write(payload)
    return n
