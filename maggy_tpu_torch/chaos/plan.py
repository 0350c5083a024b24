"""Declarative, seeded fault plans.

A verbatim copy of ``maggy_tpu/chaos/plan.py``, so one plan JSON drives
either package and both expand it to the same schedule.

A ``FaultPlan`` is a JSON-serializable list of ``FaultSpec``s plus one
seed. Every random decision the chaos engine makes (e.g. "drop this METRIC
with probability 0.05") draws from a per-spec ``random.Random`` stream
derived deterministically from ``(seed, spec index)`` — so the same plan +
seed always yields the same fault schedule over the same message/phase
stream, and two runs of a soak are comparable injection-for-injection.
``fingerprint()`` exposes that determinism as a pure value: equal plans
with equal seeds produce byte-identical fingerprints, which is what the
CLI prints and the determinism test asserts on.

A spec names WHAT to inject (kind), WHERE (target selector), and WHEN
(trigger):

kinds
    ``kill_runner``      kill the targeted runner (SIGKILL on process
                         pools; cooperative connection-death on thread
                         pools) — its trial must be requeued via
                         heartbeat loss.
    ``stall_runner``     freeze the runner for ``duration_s`` (SIGSTOP/
                         SIGCONT on process pools; RPC-hook sleep on
                         thread pools) — the classic straggler.
    ``fake_preemption``  age the runner's heartbeat record so the driver
                         declares it lost while it is actually alive —
                         the falsely-declared-lost race (duplicate-FINAL
                         path).
    ``kill_gang_member`` kill one non-leader member of an assembled
                         gang (fire it ``on_phase: gang_assembled``) —
                         the whole gang lease must be revoked, the
                         members returned to the pool, and the trial
                         requeued exactly once.
    ``kill_fork``        kill the runner a forked trial was dispatched
                         to (fire it ``on_phase: forked_from``) — the
                         trial must be requeued exactly once and resume
                         from the SAME fork point (invariant 14).
    ``drop_msg``         the server discards a matching request unseen
                         and resets the connection (message lost; the
                         client's retry path re-delivers).
    ``delay_msg``        the server stalls ``delay_s`` before handling a
                         matching request (control-plane hiccup).
    ``sever_conn``       the server handles a matching request but drops
                         the connection INSTEAD of replying — the client
                         retries and the handler runs twice
                         (at-least-once delivery).
    ``env_write_fail``   a matching ``env.dump``/``exclusive_create``
                         raises OSError (transient storage failure).

target (all keys optional; omitted = match anything)
    ``partition``   runner index the fault applies to.
    ``verb``        RPC message type (METRIC, FINAL, GET, REG, ...) for
                    message faults.
    ``path``        substring of the write path for env_write_fail.

trigger (exactly one of)
    ``after_s``      elapsed seconds since the engine was armed
                     (runner-level faults; evaluated on the server tick).
    ``nth``          the Nth matching occurrence (1-based): message for
                     message faults, write for env faults, phase
                     transition when combined with ``on_phase``.
    ``every_nth``    every Nth matching occurrence.
    ``probability``  per-occurrence Bernoulli draw from the spec's seeded
                     stream.
    ``on_phase``     a trial-span phase transition (spans.PHASES), e.g.
                     fire the kill when the Nth trial starts ``running``
                     (``nth`` defaults to 1).

``count`` caps total injections for the spec (default 1 for runner-level
faults, unbounded for message/env faults).
"""

from __future__ import annotations

import json
import random
from typing import Any, Dict, List, Optional

KINDS = (
    "kill_runner",
    "stall_runner",
    "fake_preemption",
    "preempt_trial",
    "kill_gang_member",
    "kill_fork",
    "drop_msg",
    "delay_msg",
    "sever_conn",
    "env_write_fail",
)

#: Kinds that act on a runner (fired from ticks / phase transitions), as
#: opposed to per-message / per-write faults evaluated at a hook site.
#: ``preempt_trial`` exercises the GRACEFUL checkpoint-assisted
#: preemption path (the fleet scheduler's mechanism): the driver flags
#: the partition's trial, the runner acks with its checkpoint step, and
#: the trial must resume from that step — invariant 7.
#: ``kill_gang_member`` kills one NON-LEADER member of an assembled
#: gang (trigger it ``on_phase: gang_assembled`` so the event names the
#: gang trial; the engine resolves the victim through the driver's gang
#: table) — the whole gang's lease must be revoked and the trial
#: requeued exactly once (invariant 8).
#: ``kill_fork`` kills the runner a FORKED trial was just dispatched to
#: (trigger it ``on_phase: forked_from`` — the genealogy edge names both
#: the trial and its runner): the trial must be requeued exactly once
#: and resume from the SAME fork point, lineage intact (invariant 14).
RUNNER_KINDS = ("kill_runner", "stall_runner", "fake_preemption",
                "preempt_trial", "kill_gang_member", "kill_fork")

_TRIGGER_KEYS = ("after_s", "nth", "every_nth", "probability", "on_phase")


class FaultSpec:
    """One declarative fault. Plain-dict in, plain-dict out."""

    __slots__ = ("kind", "target", "trigger", "delay_s", "duration_s", "count")

    def __init__(self, kind: str, target: Optional[Dict[str, Any]] = None,
                 trigger: Optional[Dict[str, Any]] = None,
                 delay_s: float = 0.05, duration_s: float = 1.0,
                 count: Optional[int] = None):
        if kind not in KINDS:
            raise ValueError("Unknown fault kind {!r}; choose from {}".format(
                kind, KINDS))
        self.kind = kind
        self.target = dict(target or {})
        self.trigger = dict(trigger or {})
        unknown = set(self.trigger) - set(_TRIGGER_KEYS)
        if unknown:
            raise ValueError("Unknown trigger key(s) {} in {!r} spec; valid: "
                             "{}".format(sorted(unknown), kind, _TRIGGER_KEYS))
        present = sorted(k for k in _TRIGGER_KEYS if k in self.trigger)
        if not present:
            raise ValueError(
                "{!r} spec needs a trigger (one of {})".format(
                    kind, _TRIGGER_KEYS))
        # Exactly one trigger, with the single documented combination
        # on_phase+nth ("the Nth such transition"). Anything else would
        # be resolved by silent precedence — the opposite of the
        # fail-loudly contract a chaos plan needs.
        if len(present) > 1 and present != ["nth", "on_phase"]:
            raise ValueError(
                "{!r} spec has ambiguous triggers {}: use exactly one "
                "(or on_phase combined with nth)".format(kind, present))
        # Reject combinations no hook site ever evaluates — a plan built
        # from one would be a silent no-op and the soak would pass with
        # zero injections, which is worse than failing loudly here.
        if kind in RUNNER_KINDS:
            if not ("after_s" in self.trigger or "on_phase" in self.trigger):
                raise ValueError(
                    "{!r} is a runner fault: it fires from the server tick "
                    "(after_s) or a span phase transition (on_phase), not "
                    "from per-message triggers — got {}".format(
                        kind, sorted(self.trigger)))
            if "after_s" in self.trigger and \
                    self.target.get("partition") is None:
                raise ValueError(
                    "{!r} with an after_s trigger needs target.partition: "
                    "a timed runner fault has no phase event to name its "
                    "victim (on_phase faults target the transitioning "
                    "runner)".format(kind))
        else:
            if "after_s" in self.trigger or "on_phase" in self.trigger:
                raise ValueError(
                    "{!r} is a per-occurrence fault: trigger it with nth / "
                    "every_nth / probability, not after_s/on_phase — got "
                    "{}".format(kind, sorted(self.trigger)))
        phase = self.trigger.get("on_phase")
        if phase is not None:
            from maggy_tpu_torch.telemetry.spans import PHASES

            if phase not in PHASES:
                raise ValueError(
                    "on_phase {!r} is not a span phase; valid: {}".format(
                        phase, PHASES))
        self.delay_s = float(delay_s)
        self.duration_s = float(duration_s)
        # Runner faults default to one-shot; message/env faults recur.
        if count is None:
            count = 1 if kind in RUNNER_KINDS else 0  # 0 = unbounded
        self.count = int(count)

    def to_dict(self) -> Dict[str, Any]:
        return {"kind": self.kind, "target": dict(self.target),
                "trigger": dict(self.trigger), "delay_s": self.delay_s,
                "duration_s": self.duration_s, "count": self.count}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "FaultSpec":
        return cls(kind=d["kind"], target=d.get("target"),
                   trigger=d.get("trigger"), delay_s=d.get("delay_s", 0.05),
                   duration_s=d.get("duration_s", 1.0), count=d.get("count"))

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return "FaultSpec({})".format(self.to_dict())


class FaultPlan:
    """A seed plus an ordered list of fault specs."""

    def __init__(self, specs: List[FaultSpec], seed: int = 0):
        self.specs = list(specs)
        self.seed = int(seed)

    # ------------------------------------------------------------- serialize

    def to_json(self) -> str:
        return json.dumps({"seed": self.seed,
                           "faults": [s.to_dict() for s in self.specs]},
                          indent=2)

    @classmethod
    def from_json(cls, text: str) -> "FaultPlan":
        data = json.loads(text)
        return cls([FaultSpec.from_dict(d) for d in data.get("faults", [])],
                   seed=data.get("seed", 0))

    @classmethod
    def load(cls, path: str, env=None) -> "FaultPlan":
        """Read a plan file through ``env`` when given, else the local fs."""
        if env is not None:
            return cls.from_json(env.load(path))
        with open(path) as f:
            return cls.from_json(f.read())

    # ----------------------------------------------------------- determinism

    def rng_for(self, spec_index: int) -> random.Random:
        """The spec's private decision stream. Seeded from a STRING so the
        derivation is platform-stable (str seeding hashes via sha512,
        unaffected by PYTHONHASHSEED)."""
        return random.Random("maggy_chaos:{}:{}".format(self.seed, spec_index))

    def fingerprint(self, draws: int = 64) -> List[Dict[str, Any]]:
        """Pure expansion of the plan's decision schedule: per spec, the
        trigger parameters plus (for probability triggers) the first
        ``draws`` Bernoulli outcomes of its seeded stream. Equal plan +
        equal seed => equal fingerprint; this is the artifact the
        same-seed-same-schedule acceptance check compares."""
        out = []
        for i, spec in enumerate(self.specs):
            entry: Dict[str, Any] = {"kind": spec.kind,
                                     "target": dict(spec.target),
                                     "trigger": dict(spec.trigger)}
            p = spec.trigger.get("probability")
            if p is not None:
                rng = self.rng_for(i)
                entry["decisions"] = [rng.random() < float(p)
                                      for _ in range(draws)]
            out.append(entry)
        return out
