"""Experiment monitor: ``python -m maggy_tpu_torch.monitor``.

The port's copy of ``maggy_tpu/monitor.py``: every renderer gives the same
text as the JAX package's for the same snapshot. The reference streams
progress to Jupyter by having sparkmagic poll the driver's LOG message
(`rpc.py:369-377`, `driver.py:167-175`); this standalone watcher polls the
same LOG verb over the control plane, on the port's ``MessageSocket``, from
any machine that reaches the driver, and renders a progress snapshot.

    python -m maggy_tpu_torch.monitor --ticket /shared/exp_dir/runner_ticket.json
    python -m maggy_tpu_torch.monitor --driver 10.0.0.2:41234 --secret-file s.txt --once
    python -m maggy_tpu_torch.monitor --ticket .../runner_ticket.json --telem
    python -m maggy_tpu_torch.monitor --ticket .../runner_ticket.json --health
    python -m maggy_tpu_torch.monitor --fleet <fleet home>

A driver writes ``runner_ticket.json`` for ``pool="remote"``; any other
sweep's address and secret are in its ``driver_state.json``, which
``--driver`` and ``--secret`` take.

``--fleet`` watches a shared fleet (maggy_tpu_torch.fleet) from its home dir:
per-experiment share vs configured weight, queue depth, and preemption
counts, replayed from status.json + fleet.jsonl.

``--telem`` polls the TELEM verb instead: the driver's live telemetry
snapshot (trial-span scheduling numbers + RPC service-time histograms).
``--goodput`` renders the chip-time goodput ledger over the same verb:
the experiment's goodput fraction, top badput buckets, and per-partition
held-time split (telemetry/goodput.py; docs/telemetry.md).
``--health`` renders the live health view over the same verb: the health
engine's straggler/hang/RTT flags plus per-partition runner stats (step
cadence, time-to-first-metric, heartbeat RTT, RSS) — see
docs/telemetry.md. ``--live`` scrapes the observability plane's /status
and /healthz instead.
"""

from __future__ import annotations

import argparse
import socket
import sys
import time
from typing import Any, Dict, Tuple

from maggy_tpu_torch.core.rpc import MessageSocket


def progress_bar(done: int, total: int, width: int = 30) -> str:
    """``maggy_tpu/util.py:102-105``."""
    frac = 0 if total == 0 else done / total
    filled = int(width * frac)
    return "[{}{}] {}/{}".format("=" * filled, " " * (width - filled), done, total)


def _poll(addr: Tuple[str, int], secret: str, msg_type: str,
          timeout: float = 10.0) -> Dict[str, Any]:
    key = secret.encode() if isinstance(secret, str) else secret
    sock = socket.create_connection(addr, timeout=timeout)
    try:
        MessageSocket.send_msg(sock, {"type": msg_type}, key)
        return MessageSocket.recv_msg(sock, key)
    finally:
        sock.close()


def poll_progress(addr: Tuple[str, int], secret: str,
                  timeout: float = 10.0) -> Dict[str, Any]:
    """One LOG round trip: the driver's live progress snapshot."""
    return _poll(addr, secret, "LOG", timeout=timeout)


def poll_telemetry(addr: Tuple[str, int], secret: str,
                   timeout: float = 10.0) -> Dict[str, Any]:
    """One TELEM round trip: metrics registry + span-derived scheduling
    numbers (hand-off gap, early-stop reaction, RPC service times)."""
    return _poll(addr, secret, "TELEM", timeout=timeout)


def poll_live(base_url: str,
              timeout: float = 10.0) -> Tuple[Dict[str, Any], int,
                                              Dict[str, Any]]:
    """One scrape of the observability plane (telemetry.obs): ``(status
    document, healthz HTTP code, healthz body)``. ``base_url`` is
    ``host:port`` or a full ``http://`` URL — no secret needed, the obs
    endpoints are plain HTTP (loopback-bound by default)."""
    import json as _json
    import urllib.error
    import urllib.request

    if "//" not in base_url:
        base_url = "http://" + base_url
    base_url = base_url.rstrip("/")
    with urllib.request.urlopen(base_url + "/status",
                                timeout=timeout) as resp:
        status = _json.loads(resp.read().decode())
    try:
        with urllib.request.urlopen(base_url + "/healthz",
                                    timeout=timeout) as resp:
            return status, resp.status, _json.loads(resp.read().decode())
    except urllib.error.HTTPError as e:
        # 503 = unhealthy, still a valid, body-carrying reply.
        return status, e.code, _json.loads(e.read().decode())


def render(snap: Dict[str, Any]) -> str:
    if "num_trials" in snap:  # HPO / ablation experiment
        done = snap.get("finalized", 0)
        total = snap.get("num_trials", 0)
        parts = [progress_bar(done, total)]
        if snap.get("best_val") is not None:
            parts.append("best={:.6g}".format(snap["best_val"]))
        if snap.get("early_stopped"):
            parts.append("early_stopped={}".format(snap["early_stopped"]))
        return " ".join(parts)
    if "num_workers" in snap:  # distributed training
        return progress_bar(snap.get("workers_done", 0),
                                 snap.get("num_workers", 0)) + " workers done"
    return str({k: v for k, v in snap.items() if k != "type"})


def _fmt_dist(stats: Dict[str, Any]) -> str:
    if not stats:
        return "n/a"
    return "median {} ms / p95 {} ms (n={})".format(
        stats.get("median_ms"), stats.get("p95_ms"), stats.get("n"))


def render_telem(snap: Dict[str, Any]) -> str:
    """Multi-line view of a TELEM snapshot: the scheduling numbers the
    paper's efficiency claim rests on, plus the busiest RPC verbs."""
    if snap.get("type") == "ERR":
        return "telemetry: {}".format(snap.get("error"))
    if not snap.get("enabled", True):
        return "telemetry: disabled for this experiment"
    spans = snap.get("spans") or {}
    trials = spans.get("trials") or {}
    lines = [
        "trials: {} queued / {} finalized / {} early-stopped / {} errors"
        " / {} lost".format(trials.get("created", 0),
                            trials.get("finalized", 0),
                            trials.get("early_stopped", 0),
                            trials.get("errors", 0), trials.get("lost", 0)),
        "hand-off gap: {}".format(_fmt_dist(spans.get("handoff") or {})),
        "early-stop reaction: {}".format(
            _fmt_dist(spans.get("early_stop_reaction") or {})),
    ]
    if (spans.get("requeue_recovery") or {}).get("n"):
        # Only shown when recovery actually happened: a healthy run has
        # no requeues and the line would be noise.
        lines.append("requeue recovery: {}".format(
            _fmt_dist(spans["requeue_recovery"])))
    suggest = spans.get("suggest") or {}
    if suggest:
        # Pipelined hand-off health: how many hand-offs rode the FINAL
        # reply vs fell back to GET, and what a suggest() costs.
        lines.append(
            "hand-off pipeline: {} hits / {} misses (hit rate {}), "
            "suggest {}".format(
                suggest.get("prefetch_hits", 0),
                suggest.get("prefetch_misses", 0),
                suggest.get("hit_rate"),
                _fmt_dist(suggest.get("latency") or {})))
    comp = spans.get("compile") or {}
    if comp:
        # Compile-once hot path: how many trials rode a warm program vs
        # paid a fresh trace+compile, and what each cost.
        lines.append(
            "compile-once: {} warm / {} cold (hit rate {}), ttfm warm "
            "{} vs cold {}".format(
                comp.get("warm_hits", 0), comp.get("warm_misses", 0),
                comp.get("warm_hit_rate"),
                _fmt_dist(comp.get("ttfm_warm") or {}),
                _fmt_dist(comp.get("ttfm_cold") or {})))
        cache = comp.get("cache") or {}
        if cache:
            lines.append(
                "  xla persistent cache: {} hits / {} misses (hit rate "
                "{})".format(cache.get("hits", 0), cache.get("misses", 0),
                             cache.get("hit_rate")))
    fork = spans.get("fork") or {}
    if fork:
        # Checkpoint-forking search: promotions/exploits that RESUMED a
        # parent's checkpoint vs re-trained from scratch, and what each
        # fork saved / cost.
        lines.append(
            "forking: {} forked / {} from-scratch, {} steps saved, "
            "load {}{}".format(
                fork.get("forked", 0), fork.get("from_scratch", 0),
                fork.get("steps_saved", 0),
                _fmt_dist(fork.get("fork_load_ms") or {}),
                ", {} ckpt GC'd".format(fork["ckpt_gc"])
                if fork.get("ckpt_gc") else ""))
    hists = (snap.get("metrics") or {}).get("histograms") or {}
    rpc = sorted(((name, h) for name, h in hists.items()
                  if name.startswith("rpc.handle_ms.")),
                 key=lambda kv: -kv[1].get("count", 0))
    for name, h in rpc[:5]:
        lines.append("rpc {}: n={} p50 {} ms p95 {} ms".format(
            name[len("rpc.handle_ms."):], h.get("count"),
            h.get("p50"), h.get("p95")))
    health = snap.get("health") or {}
    if health.get("flags"):
        # One summary line; the full view lives under --health.
        lines.append("health: {} active flag(s) — run with --health for "
                     "detail".format(len(health["flags"])))
    torn = (snap.get("journal") or {}).get("torn_lines") or 0
    if torn:
        lines.append("WARNING: journal has {} torn/corrupt line(s) "
                     "(events were lost)".format(torn))
    return "\n".join(lines)


def _fmt_flag(flag: Dict[str, Any]) -> str:
    check = flag.get("check")
    pid = flag.get("partition")
    if check == "hang":
        return ("  [hang] partition {}: trial {} silent {}s "
                "({} bound {}s; thread dump journaled)".format(
                    pid, flag.get("trial"), flag.get("silent_s"),
                    flag.get("window", "steady"), flag.get("bound_s")))
    if check == "straggler":
        return ("  [straggler] partition {}: {} {} ms vs fleet median {} ms"
                " (score {})".format(
                    pid, flag.get("metric"), flag.get("value_ms"),
                    flag.get("fleet_median_ms"), flag.get("score")))
    if check == "hb_rtt":
        return ("  [hb_rtt] partition {}: heartbeat RTT {} ms vs fleet "
                "median {} ms".format(pid, flag.get("value_ms"),
                                      flag.get("fleet_median_ms")))
    return "  [{}] partition {}: {}".format(
        check, pid, {k: v for k, v in flag.items()
                     if k not in ("check", "partition")})


def render_health(snap: Dict[str, Any]) -> str:
    """Multi-line view of the TELEM snapshot's health section: active
    straggler/hang/RTT flags plus a per-partition runner-stats table."""
    if snap.get("type") == "ERR":
        return "telemetry: {}".format(snap.get("error"))
    if not snap.get("enabled", True):
        return "telemetry: disabled for this experiment"
    health = snap.get("health")
    if health is None:
        return "health: engine not running (health=False or pre-health " \
               "driver)"
    flags = health.get("flags") or []
    lines = ["health: {} active flag(s), {} raised total, {} checks "
             "run".format(len(flags), health.get("raised_total", 0),
                          health.get("checks_run", 0))]
    for flag in flags:
        lines.append(_fmt_flag(flag))
    runners = snap.get("runners") or {}
    for pid in sorted(runners, key=int):
        s = runners[pid]
        lines.append(
            "  runner {}: trial={} steps={} cadence={} ms ttfm={} ms "
            "hb_rtt={} ms rss={} MB".format(
                pid, s.get("trial"), s.get("steps"), s.get("cadence_ms"),
                s.get("ttfm_ms"), s.get("hb_rtt_ms"), s.get("rss_mb")))
    torn = (snap.get("journal") or {}).get("torn_lines") or 0
    if torn:
        lines.append("WARNING: journal has {} torn/corrupt line(s) "
                     "(events were lost)".format(torn))
    return "\n".join(lines)


def render_goodput_view(snap: Dict[str, Any]) -> str:
    """Multi-line view of the TELEM snapshot's goodput ledger: the
    fleet's goodput fraction, the top badput buckets, and each
    partition's held-time split (telemetry/goodput.py)."""
    if snap.get("type") == "ERR":
        return "telemetry: {}".format(snap.get("error"))
    if not snap.get("enabled", True):
        return "telemetry: disabled for this experiment"
    from maggy_tpu_torch.telemetry.goodput import render_goodput

    block = (snap.get("spans") or {}).get("goodput") or {}
    return "\n".join(render_goodput(block))


def render_live(status: Dict[str, Any], healthz_code: int,
                healthz: Dict[str, Any]) -> str:
    """Multi-line view of one obs /status + /healthz scrape: a header
    per registered experiment (progress, backlog, reservations, gangs,
    fleet share) above the familiar telemetry block."""
    lines = ["healthz: {} ({})".format(
        healthz_code, healthz.get("status", "?"))]
    for flags in (e.get("flags") or []
                  for e in (healthz.get("experiments") or {}).values()):
        for flag in flags:
            lines.append(_fmt_flag(flag))
    experiments = status.get("experiments") or {}
    if not experiments:
        lines.append("no experiments registered")
    for key in sorted(experiments):
        doc = experiments[key]
        st = doc.get("status") or {}
        progress = st.get("progress") or {}
        lines.append("== {} ({}) ==".format(
            (doc.get("labels") or {}).get("experiment", key), key))
        if "num_trials" in progress or "finalized" in progress:
            lines.append("progress: {}/{} finalized, best={}".format(
                progress.get("finalized", "?"),
                progress.get("num_trials", "?"),
                progress.get("best_val")))
        store = st.get("store") or {}
        if store:
            lines.append(
                "store: {} trials / {} finalized / {} requeued / {} "
                "parked / {} gang-waiting".format(
                    store.get("trials", 0), store.get("finalized", 0),
                    store.get("requeue", 0), store.get("parked", 0),
                    store.get("gang_wait", 0)))
        reservations = st.get("reservations") or {}
        if reservations:
            busy = sum(1 for r in reservations.values() if r.get("trial"))
            lines.append("runners: {} registered, {} busy".format(
                len(reservations), busy))
        gangs = st.get("gangs") or {}
        for tid, g in sorted(gangs.items()):
            lines.append("gang {}: {} chips, members {}, leader {}{}".format(
                tid, g.get("chips"), g.get("members"), g.get("leader"),
                " [revoking]" if g.get("revoking") else ""))
        fleet = st.get("fleet") or {}
        if fleet:
            lines.append("fleet: {} runner(s), {} active, queue depth "
                         "{}".format(fleet.get("fleet_size"),
                                     fleet.get("active"),
                                     fleet.get("queue_depth")))
        telem = doc.get("telem") or {}
        if telem.get("enabled"):
            lines.extend("  " + ln for ln in render_telem(telem).split("\n"))
    return "\n".join(lines)


def render_fleet(status: Dict[str, Any],
                 replay: Dict[str, Any]) -> str:
    """Multi-line view of a fleet: scheduler status (from status.json)
    plus journal-replayed shares/queue-waits/preemptions — who holds the
    runners, who is waiting, and whether the split tracks the weights."""
    if not status and not replay:
        return "fleet: no status.json or fleet.jsonl yet"
    lines = ["fleet {}: {} runner(s), {} active, queue depth {}{}".format(
        status.get("name", "?"), status.get("runners", "?"),
        status.get("active", 0), status.get("queue_depth", 0),
        " [stopped]" if status.get("stopped") else "")]
    shares = replay.get("share") or {}
    expected = replay.get("expected_share") or {}
    rexps = replay.get("experiments") or {}
    for exp in status.get("experiments", []):
        name = exp.get("name")
        extra = ""
        if name in shares:
            extra = ", share {} (want {})".format(shares[name],
                                                  expected.get(name))
        qw = (rexps.get(name) or {}).get("queue_wait_s",
                                         exp.get("queue_wait_s"))
        lines.append(
            "  {} [{}, prio {}, w {}]: {} runner(s), {} lease(s), "
            "{} preemption(s), queue wait {}s{}".format(
                name, exp.get("state"), exp.get("priority"),
                exp.get("weight"), exp.get("allocated"), exp.get("leases"),
                exp.get("preemptions"), qw, extra))
    agents = status.get("agents") or []
    if agents or status.get("max_agents"):
        lines.append("agents: {} joined / {} slot(s)".format(
            len(agents), status.get("max_agents", "?")))
        for a in agents:
            lines.append(
                "  {} [runner {}, {}@{}, {} chip(s)]: {}{}, {} lease(s), "
                "last beat {}s ago".format(
                    a.get("agent"), a.get("runner"),
                    a.get("process_index"), a.get("host"), a.get("chips"),
                    a.get("state"),
                    " -> {}".format(a.get("lease")) if a.get("lease")
                    else "",
                    a.get("leases"), a.get("last_beat_age_s")))
    sink = status.get("sink") or {}
    if sink:
        # Per-source telemetry fan-in lag: how far behind the unified
        # journal dir is for each tenant/agent — backlog still buffered
        # fleet-side plus the age of the newest ingested event. A
        # DEGRADED source's shipper lost the sink and is journaling
        # locally (it re-ships on reconnect).
        lines.append("journal sink: {} source(s)".format(len(sink)))
        for src, s in sorted(sink.items()):
            lines.append(
                "  {}: backlog {}, last event {}s ago, "
                "{} event(s) in {} batch(es){}".format(
                    src, s.get("backlog", 0),
                    s.get("last_event_age_s"),
                    s.get("ingested"), s.get("batches"),
                    " DEGRADED" if s.get("degraded") else ""))
    sreplay = replay.get("sink") or {}
    if sreplay.get("batches"):
        lag = sreplay.get("lag_ms") or {}
        lines.append(
            "sink ingest: {} event(s) / {} batch(es) from {} source(s), "
            "lag p50 {} ms / p95 {} ms, {} dup dropped".format(
                sreplay.get("events"), sreplay.get("batches"),
                sreplay.get("sources"), lag.get("median_ms"),
                lag.get("p95_ms"), sreplay.get("dup", 0)))
    areplay = replay.get("agents") or {}
    if areplay.get("joins"):
        abind = areplay.get("abind_ms") or {}
        lines.append(
            "agent plane: {} join(s), {} lease(s) delivered (abind p50 "
            "{} ms / p95 {} ms), {} lost ({} lease(s) revoked)".format(
                areplay.get("joins"), areplay.get("leases"),
                abind.get("median_ms"), abind.get("p95_ms"),
                areplay.get("losses", 0), areplay.get("lost_leases", 0)))
    if replay.get("share_error") is not None:
        lines.append("share error vs weights: {} (overlap window)".format(
            replay["share_error"]))
    if replay.get("preemptions"):
        lines.append("preemptions: {}".format(replay["preemptions"]))
    if status.get("shed") or replay.get("sheds"):
        # Load shedding happened: the fleet refused submissions at its
        # admission bound — say so next to the queue numbers.
        lines.append("shed submissions: {} (admission bound {})".format(
            status.get("shed", replay.get("sheds")),
            status.get("max_queued")))
    qwd = replay.get("queue_wait_ms") or {}
    if qwd:
        lines.append("queue wait: p50 {} ms / p95 {} ms (n={})".format(
            qwd.get("median_ms"), qwd.get("p95_ms"), qwd.get("n")))
    if replay.get("decisions_per_s"):
        lines.append("scheduler decisions: {} ({}/s); admission p99 {} "
                     "ms".format(replay.get("decisions"),
                                 replay.get("decisions_per_s"),
                                 replay.get("admission_p99_ms")))
    return "\n".join(lines)


def _poll_fleet(home: str) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    import json as _json
    import os as _os

    from maggy_tpu_torch.fleet import FLEET_JOURNAL_NAME, replay_fleet_journal

    if home.endswith("status.json"):
        home = _os.path.dirname(home)
    status: Dict[str, Any] = {}
    status_path = _os.path.join(home, "status.json")
    if _os.path.exists(status_path):
        with open(status_path) as f:
            status = _json.load(f)
    journal = _os.path.join(home, FLEET_JOURNAL_NAME)
    replay = replay_fleet_journal(journal) if _os.path.exists(journal) \
        else {}
    return status, replay


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="maggy_tpu_torch.monitor", description="Watch a running experiment.")
    p.add_argument("--ticket", help="path to the driver's runner_ticket.json")
    p.add_argument("--driver", help="driver control-plane address HOST:PORT")
    p.add_argument("--secret", help="shared experiment secret (hex)")
    p.add_argument("--secret-file", help="file containing the shared secret")
    p.add_argument("--interval", type=float, default=2.0,
                   help="seconds between polls (default 2)")
    p.add_argument("--once", action="store_true",
                   help="print one snapshot and exit")
    p.add_argument("--logs", action="store_true",
                   help="also stream executor log lines (reporter.log and, "
                        "with ship_prints=True, the train function's print() "
                        "output)")
    p.add_argument("--telem", action="store_true",
                   help="poll the TELEM verb instead of LOG: span-derived "
                        "scheduling numbers (hand-off gap, early-stop "
                        "reaction) and RPC service-time histograms "
                        "(mutually exclusive with --logs, which streams "
                        "over the LOG verb)")
    p.add_argument("--health", action="store_true",
                   help="poll the TELEM verb and render the live health "
                        "view: straggler/hang/RTT flags from the driver's "
                        "health engine plus per-partition runner stats "
                        "(step cadence, time-to-first-metric, heartbeat "
                        "RTT, RSS)")
    p.add_argument("--goodput", action="store_true",
                   help="poll the TELEM verb and render the chip-time "
                        "goodput ledger: the experiment's goodput "
                        "fraction, top badput buckets (compile, rework, "
                        "idle, ...), and per-partition held-time split")
    p.add_argument("--live", metavar="HOST:PORT",
                   help="watch via the observability plane instead of the "
                        "RPC verbs: scrape GET /status + /healthz from a "
                        "driver/fleet started with config.obs_port (or "
                        "MAGGY_TPU_OBS_PORT) — no secret needed; the "
                        "bound address is journaled as obs_started")
    p.add_argument("--fleet", metavar="HOME",
                   help="watch a shared fleet instead of one experiment: "
                        "renders per-experiment share, queue depth, and "
                        "preemption counts from the fleet home dir's "
                        "status.json + fleet.jsonl (no RPC — works after "
                        "the fleet exits too)")
    args = p.parse_args(argv)
    if (args.telem or args.health or args.goodput) and args.logs:
        p.error("--logs streams over the LOG verb; run it without "
                "--telem/--health/--goodput (or use two monitor "
                "processes)")
    if args.live:
        if args.telem or args.health or args.logs or args.fleet \
                or args.goodput:
            p.error("--live scrapes the obs HTTP endpoints; drop "
                    "--telem/--health/--logs/--fleet/--goodput")
        polled_ok = False
        failures = 0
        last = None
        while True:
            try:
                status, code, healthz = poll_live(args.live)
            except OSError as e:
                if not polled_ok:
                    print("cannot reach obs server at {}: {}".format(
                        args.live, e), file=sys.stderr)
                    return 1
                failures += 1
                if failures >= 3:
                    print("experiment finished (obs server gone)")
                    return 0
                time.sleep(args.interval)
                continue
            failures = 0
            polled_ok = True
            line = render_live(status, code, healthz)
            if line != last:
                print(line, flush=True)
                last = line
            if args.once:
                return 0
            time.sleep(args.interval)
    if args.fleet:
        if args.telem or args.health or args.logs or args.goodput:
            p.error("--fleet is file-based; drop "
                    "--telem/--health/--logs/--goodput")
        last = None
        while True:
            status, replay = _poll_fleet(args.fleet)
            line = render_fleet(status, replay)
            if line != last:
                print(line, flush=True)
                last = line
            if args.once:
                return 0
            time.sleep(args.interval)

    if args.ticket:
        from maggy_tpu_torch.runner import read_ticket

        ticket = read_ticket(args.ticket, wait_s=0)
        addr = (ticket["host"], int(ticket["port"]))
        secret = ticket["secret"]
    elif args.driver:
        host, _, port = args.driver.rpartition(":")
        addr = (host, int(port))
        if args.secret_file:
            with open(args.secret_file) as f:
                secret = f.read().strip()
        elif args.secret:
            secret = args.secret
        else:
            p.error("--driver requires --secret or --secret-file")
    else:
        p.error("one of --ticket or --driver is required")

    polled_ok = False
    consecutive_failures = 0
    logs_seen = 0
    while True:
        try:
            snap = (poll_telemetry
                    if (args.telem or args.health or args.goodput)
                    else poll_progress)(addr, secret)
        except (ConnectionError, socket.timeout, OSError) as e:
            if not polled_ok:
                print("cannot reach driver at {}:{}: {}".format(
                    addr[0], addr[1], e), file=sys.stderr)
                return 1
            # Distinguish a transient blip (driver briefly saturated) from a
            # finished experiment: require a few consecutive failures.
            consecutive_failures += 1
            if consecutive_failures >= 3:
                print("experiment finished (driver gone)")
                return 0
            time.sleep(args.interval)
            continue
        consecutive_failures = 0
        polled_ok = True
        if args.health:
            print(render_health(snap), flush=True)
        elif args.goodput:
            print(render_goodput_view(snap), flush=True)
        else:
            print(render_telem(snap) if args.telem else render(snap),
                  flush=True)
        if args.logs:
            total = snap.get("log_total", 0)
            tail = snap.get("log_tail", [])
            missed = total - logs_seen - len(tail)
            if logs_seen and missed > 0:
                print("  | ... {} line(s) skipped (poll faster or read the "
                      "executor logs)".format(missed), flush=True)
            new = min(total - logs_seen, len(tail))
            for line in (tail[-new:] if new > 0 else []):
                print("  | {}".format(line), flush=True)
            logs_seen = max(logs_seen, total)
        if args.once:
            return 0
        time.sleep(args.interval)


if __name__ == "__main__":
    sys.exit(main())
