"""The journal vocabulary: every string the telemetry journal speaks.

A verbatim copy of ``maggy_tpu/telemetry/vocab.py``: both packages write
the same strings, so either package's replay reads the other's journal.
The port emits all of it, the gang vocabulary included.

One home for the stringly-typed contract between EMITTERS (``Telemetry.
trial_event`` / ``Telemetry.event`` call sites across the package) and
CONSUMERS (``spans.derive`` / ``replay_journal``, ``trace.py``,
``monitor``, ``chaos/harness.py`` invariants, ``fleet.replay_fleet_
journal``). An emitter typo used to vanish silently from replay,
Perfetto, and invariant checking all at once; the ``journalvocab``
checker (``python -m maggy_tpu.analysis``) now statically verifies

- every literal phase/kind/reason EMITTED appears here,
- every entry here is emitted somewhere (no orphan vocabulary), and
- every literal a CONSUMER matches against appears here (a consumer typo
  matches nothing — the worst kind of false green).

Extend the vocabulary here FIRST, then emit/consume. Entries are plain
frozensets so the checker (pure AST, no imports) can read them
literally: keep every entry a literal string in this file.
"""

from __future__ import annotations

#: Trial-span lifecycle + annotation phases (``ev: "trial"`` events).
#: Nominal order; see telemetry/spans.py for the semantics of each.
SPAN_PHASES = (
    "suggested", "queued", "assigned", "running", "first_metric",
    "stop_flagged", "stop_sent", "finalized", "lost", "requeued",
    "profile_skipped", "prefetch_hit", "prefetch_miss",
    "preempt_requested", "preempted", "resumed", "compiled",
    # Gang scheduling (maggy_tpu.gang): the trial's contiguous chip
    # block became fully held and the leader was dispatched / the
    # block's chips returned to the pool (fields: members, chips; the
    # pair brackets the trial's N-chip busy interval in replay_pack).
    "gang_assembled", "gang_released",
    # Checkpoint-forking search (docs/user.md "Forking search"): this
    # trial was dispatched to RESUME from another trial's checkpoint —
    # an ASHA promotion continuing its rung parent, a PBT exploit
    # copying the winner, a BO near-duplicate warm start. Fields:
    # parent (the source trial id), step (the checkpoint step forked
    # from), partition. The genealogy edge trace.py renders as a
    # parent→child Perfetto flow arrow and derive()'s fork block counts
    # steps_saved from.
    "forked_from",
    # Runner-measured checkpoint I/O totals for one trial, shipped once
    # at trial end through the heartbeat stats channel (mirrors
    # "compiled"). Fields: save_ms, restore_ms, saves, restores,
    # partition. The goodput ledger's ckpt_save / ckpt_restore badput
    # buckets fold from this record.
    "ckpt_saved",
)

#: Top-level journal event kinds (the ``ev`` field).
EVENT_KINDS = frozenset({
    "trial",                  # span phase occurrence (phase in SPAN_PHASES)
    "suggest",                # controller suggest() latency sample
    "runner_stats",           # heartbeat-piggybacked runner stats delta
    "runner",                 # trial-runner lifecycle (phase: RUNNER_PHASES)
    "worker",                 # dist-worker lifecycle (phase: WORKER_PHASES)
    "experiment",             # experiment lifecycle (phase: EXPERIMENT_PHASES)
    "prefetch_invalidated",   # schedule-stale prefetches dropped
    "chaos",                  # one fault injection
    "chaos_armed",            # chaos engine armed for the experiment
    "chaos_summary",          # end-of-experiment injection tally
    "health",                 # health engine finding / lifecycle
    "fleet",                  # fleet lifecycle (phase: FLEET_PHASES)
    "fleet_submit",           # experiment submitted to the fleet
    "fleet_admit",            # experiment admitted past the queue
    "fleet_experiment",       # per-experiment fleet lifecycle
    "lease",                  # runner lease start/end (phase: LEASE_PHASES)
    "preempt",                # fleet preemption decision
    "pack",                   # gang placer decision (op: init/reserve/
                              #   stall/release — maggy_tpu.gang)
    "obs_started",            # observability server bound (host, port) —
                              #   journaled so tools can discover an
                              #   ephemeral (port 0) bind
    "profile_captured",       # device profile + thread dump artifact
                              #   written (path, reason: manual|auto,
                              #   check, partition — telemetry.profiling)
    "shed",                   # load shed: an admission refused at the
                              #   fleet's max_queued bound (scope=
                              #   "admission", fleet journal) or a frame+
                              #   connection dropped at a tenant's full
                              #   dispatch queue (scope="rpc", tenant
                              #   journal) — rpc.SharedServer /
                              #   fleet.FleetScheduler
    "agent",                  # remote fleet-agent lifecycle (phase:
                              #   AGENT_PHASES — fleet journal lane per
                              #   agent; maggy_tpu.fleet.agent)
    "jsink",                  # journal-sink ingest record: one JSINK
                              #   batch demuxed into a per-source
                              #   segment (source, n, dup, sid, lag_ms —
                              #   fleet journal; telemetry/sink.py)
    "sink_degraded",          # a source's shipper lost the sink and
                              #   fell back to its local journal
                              #   (telemetry/sink.py SinkJournal)
    "sink_recovered",         # the shipper reconnected; the spooled
                              #   suffix re-ships (sid-deduped)
    "clock_offset",           # RTT-bounded clock-offset estimate for
                              #   one agent vs the fleet host (offset_s,
                              #   rtt_s — Cristian's algorithm over the
                              #   AJOIN/ALEASE exchange; journaled
                              #   fleet-side per agent and agent-side)
    "driver_epoch",           # driver incarnation boundary: a (re)started
                              #   driver journals the epoch it claimed via
                              #   util.claim_driver_epoch — the seam
                              #   crash-only recovery and invariant 13
                              #   split a multi-incarnation journal on
    "ckpt_gc",                # checkpoint garbage collection: a parent
                              #   rung's checkpoint dir retired once no
                              #   live or schedulable child can still
                              #   fork from it (trial, parent of no one
                              #   pending — fields: trial, why; bounds
                              #   disk growth of forking sweeps)
})

#: ``reason=`` on a trial ``requeued`` phase: why it re-entered the
#: schedule.
REQUEUE_REASONS = frozenset({
    "blacklist",        # executor died and re-registered (BLACK path)
    "heartbeat_loss",   # runner went silent holding the trial (LOST path)
    "dead_partition",   # fresh suggestion rerouted off a dead runner
    "preempted",        # graceful scheduler preemption (resume-capable)
    "gang_member_lost",  # a gang member died: whole lease revoked, the
                         # trial reassembles a fresh gang (exactly once)
    "fork_source_lost",  # a forked trial's staged checkpoint AND its
                         # parent's vanished before re-dispatch (disk
                         # loss / raced GC): the fork is downgraded to a
                         # from-scratch run — journaled so genealogy
                         # shows the downgrade instead of a silent
                         # restart-at-0
    "vmap_block_lost",   # a vectorized block's runner died (LOST/BLACK)
                         # or its leader was preempted: every live lane
                         # requeues exactly once as an individual scalar
                         # trial (chaos invariant 16 — no phantom FINALs,
                         # no lane lost to the block seam)
})

#: ``reason=`` on a ``profile_captured`` event: what triggered the
#: capture — an operator /profilez request or the health engine's
#: first-flag auto-capture hook (telemetry/profiling.py).
PROFILE_REASONS = frozenset({"manual", "auto"})

#: ``phase=`` per non-trial event kind.
#: ``recovered`` = crash-only recovery rebuilt the control plane from
#: the journal (trial store + reservations + controller state); fields
#: carry the reconstruction counts (inflight, adopted_partitions, ...).
EXPERIMENT_PHASES = frozenset({"start", "resumed", "recovered",
                               "finalized", "end"})
#: ``adopted`` = a pre-crash runner's first message re-bound it to the
#: restarted driver (JOIN resume path / heartbeat / retried FINAL).
RUNNER_PHASES = frozenset({"registered", "adopted"})
WORKER_PHASES = frozenset({"registered", "finalized"})
FLEET_PHASES = frozenset({"start", "stop"})
#: fleet_experiment mirrors the scheduler entry states.
FLEET_EXPERIMENT_PHASES = frozenset({"start", "done", "failed"})
LEASE_PHASES = frozenset({"start", "end"})
#: ``reason=`` on a lease ``end``. ``agent_lost`` = the remote agent
#: serving the lease went silent past the liveness bound mid-lease (the
#: fleet revoked it; the experiment's own slot-reclaim liveness requeues
#: the trial exactly once).
LEASE_END_REASONS = frozenset({"released", "error", "agent_lost"})
#: ``phase=`` on an ``agent`` event: one remote agent's lifecycle in the
#: fleet journal — join (AJOIN admitted), lease (ABIND delivered), done
#: (ADONE received, lease closed), lost (silent past the liveness
#: bound), leave (orderly exit / fleet shutdown).
AGENT_PHASES = frozenset({"join", "lease", "done", "lost", "leave"})

#: Chaos fault kinds — the ``kind=`` field of ``ev: "chaos"`` injection
#: records (mirrors chaos/plan.py KINDS; the chaos plan validates kinds
#: at build time, this copy lets replay/trace/invariant consumers be
#: checked without importing the chaos engine).
CHAOS_KINDS = frozenset({
    "kill_runner", "stall_runner", "fake_preemption", "preempt_trial",
    "kill_gang_member",
    "drop_msg", "delay_msg", "sever_conn", "env_write_fail",
    # Fleet scale soak (fleet/soak.py run_slow_tenant_soak): one tenant's
    # handlers artificially delayed — the head-of-line-isolation fault.
    # Injected by the soak harness (not a plan.py fault kind): it wraps
    # ONE experiment's handle_message, which per-verb plan targeting
    # cannot express (partition ids overlap across tenants).
    "slow_tenant",
    # Agent soak (fleet/soak.py run_agent_soak): a remote agent process
    # SIGKILLed mid-lease — invariant 11 (lease revoked, trial requeued
    # exactly once). Harness-injected like slow_tenant: the chaos plan's
    # pool-level kill cannot reach an agent in another OS process.
    "kill_agent",
    # Sink soak (fleet/soak.py run_sink_soak): the fleet's journal-sink
    # tenant detached mid-soak — invariant 12 (shippers degrade to local
    # journals, re-ship on reconnect, zero lost / zero duplicate events
    # per event id, zero experiment failures). Harness-injected: the
    # sink is fleet infrastructure, not an experiment-plan target.
    "kill_sink",
    # Driver soak (chaos/driver_soak.py run_driver_soak): the DRIVER
    # process SIGKILLed mid-sweep and restarted with resume — invariant
    # 13 (journal replay rebuilds the control plane; no trial lost, no
    # duplicate FINAL, completed trials never re-run, the sweep
    # completes on survivors). Harness-injected: the fault kills the
    # process that owns the chaos engine, so no in-process plan can
    # record it — the soak appends the record to the quiesced journal.
    "kill_driver",
    # Fork soak (chaos/harness.py run_fork_soak, `--fork`): the runner
    # a forked trial was just dispatched to is killed (plan kind, fired
    # on_phase=forked_from) — invariant 14: exactly-once requeue
    # resuming from the SAME fork point, genealogy intact.
    "kill_fork",
})

#: The goodput ledger's closed chip-time taxonomy (telemetry/goodput.py):
#: every held runner-second folds into exactly one bucket. ``train`` is
#: goodput; everything else is badput; ``unaccounted`` is the explicit
#: residual the bench gate bounds (never silently absorbed into another
#: bucket). Order is the canonical reporting order.
GOODPUT_BUCKETS = (
    "train",          # inside train_fn, productive (first-run) steps
    "init",           # sharded state init (compiled record init_ms)
    "trace",          # jaxpr trace (compiled record trace_ms)
    "compile",        # XLA compile (compiled record compile_ms)
    "ckpt_save",      # checkpoint writes (ckpt_saved record save_ms)
    "ckpt_restore",   # checkpoint reads (ckpt_saved record restore_ms)
    "fork_stage",     # parent-checkpoint staging (fork_load_ms)
    "rework",         # re-trained work: dead attempts + from-scratch
                      #   promotions re-running the parent prefix
    "handoff",        # FINAL -> next running gap (< HANDOFF_CAP_S)
    "queue_wait",     # runner registered -> first trial running
    "idle",           # reserved but trial-less (rung barriers, drain)
    "lane_idle",      # vectorized blocks (config.vmap_lanes): a masked
                      #   (early-stopped) lane's share of block chip-time
                      #   after its own FINAL while surviving lanes kept
                      #   training — the price of lockstep execution
    "unaccounted",    # residual the accounting could not attribute
)

#: Health-engine event fields (``ev: "health"``).
HEALTH_STATUSES = frozenset({"raised", "cleared", "started", "error"})
HEALTH_CHECKS = frozenset({"engine", "straggler", "hb_rtt", "hang"})

#: Everything a consumer may match a ``phase`` field against — the union
#: the journalvocab checker verifies consumer literals into.
ALL_PHASES = (frozenset(SPAN_PHASES) | EXPERIMENT_PHASES | RUNNER_PHASES
              | WORKER_PHASES | FLEET_PHASES | FLEET_EXPERIMENT_PHASES
              | LEASE_PHASES | AGENT_PHASES)
ALL_REASONS = REQUEUE_REASONS | LEASE_END_REASONS | PROFILE_REASONS

__all__ = [
    "SPAN_PHASES", "EVENT_KINDS", "REQUEUE_REASONS", "PROFILE_REASONS",
    "GOODPUT_BUCKETS",
    "EXPERIMENT_PHASES", "RUNNER_PHASES", "WORKER_PHASES",
    "FLEET_PHASES", "FLEET_EXPERIMENT_PHASES", "LEASE_PHASES",
    "LEASE_END_REASONS", "AGENT_PHASES", "CHAOS_KINDS",
    "HEALTH_STATUSES", "HEALTH_CHECKS", "ALL_PHASES", "ALL_REASONS",
]
