"""Typed experiment configs; the config type selects the experiment kind.

The subset of ``maggy_tpu/config.py`` the port runs: `LagomConfig` (with the
heartbeat-loss shape, fault injection, the live health engine and the
observability plane) and `OptimizationConfig` with the fields of a sweep
over thread, process, GPU-pinned process or remote runners, with
heartbeat-loss requeue, the telemetry journal, the compile-once warm path
(``warm_start``), checkpoint forking (``fork``) and experiment resume
(``resume``), vectorized lanes (``vmap_lanes``) and a shared fleet's
binding (``fleet``, set by ``Fleet.submit``) with its journal-sink opt-in
(``sink``), the per-trial ``profile`` and ``ship_prints``,
`AblationConfig` for LOCO ablation studies, and `DistributedConfig` for
distributed training of one model. ``chips_per_budget`` declares
multi-chip trials (JAX ``maggy_tpu/config.py:150-184, 252-294``): on the
thread pool or in fleet mode its values gang-schedule (``gang.GangSpec``;
a bare int N is GangSpec(N)), and on ``pool="elastic"`` its int values
size respawnable pinned runners within ``total_chips``. Parity: reference
`maggy/experiment_config.py:18-50`.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Union

from maggy_tpu_torch import constants
from maggy_tpu_torch.searchspace import Searchspace

#: Runner pools the port runs.
POOLS = ("thread", "process", "gpu", "elastic", "remote")


@dataclass
class LagomConfig:
    """Base config (reference `experiment_config.py:18-23`). A runner is
    declared lost after max(hb_loss_min_s, hb_interval * hb_loss_factor)
    seconds of silence unless the experiment sets ``hb_loss_timeout``.
    ``telemetry`` writes the experiment's journal, ``<exp_dir>/
    telemetry.jsonl`` (``maggy_tpu/config.py:31-36``); with it off, no
    journal is written and result.json's event-derived counts (prefetch
    hits and misses, suggest latencies, hand-off gaps, requeues) are
    empty."""

    name: str = "maggyTpuTorchExperiment"
    #: Free text kept in the experiment's metadata (``maggy_tpu/config.py:
    #: 26``).
    description: str = ""
    hb_interval: float = constants.DEFAULT_HEARTBEAT_INTERVAL_S
    #: A live progress line on stdout while the experiment runs, and the
    #: result summary at its end (``maggy_tpu/config.py:28-30``).
    verbose: bool = False
    hb_loss_factor: float = constants.HEARTBEAT_LOSS_FACTOR
    hb_loss_min_s: float = constants.HEARTBEAT_LOSS_MIN_S
    telemetry: bool = True
    #: Fault injection (``maggy_tpu_torch.chaos``, ``maggy_tpu/config.py:
    #: 40-43``): a FaultPlan or the path of a plan JSON; None (the default)
    #: leaves every chaos hook a no-op. Also armed by
    #: MAGGY_TPU_CHAOS=<plan.json>. Requires telemetry.
    chaos: Any = None
    #: Live health engine (``telemetry/health.py``): periodic straggler,
    #: heartbeat-RTT and hang checks over the spans and runner stats,
    #: journaled as ``health`` events and carried by the TELEM snapshot. On
    #: by default, as in the JAX package; off when telemetry is.
    health: bool = True
    #: Seconds between health checks; None -> max(0.25, hb_interval).
    health_interval_s: Optional[float] = None
    #: Hang watchdog: a partition holding a trial with no progress for
    #: ``health_hang_factor * hb_interval`` seconds is flagged (4x that
    #: before the trial's first metric).
    health_hang_factor: float = 25.0
    #: Observability plane (``telemetry/obs.py``): an HTTP server with GET
    #: /metrics (Prometheus text), /status, /healthz (200 or 503) and
    #: /profilez (an on-demand torch.profiler capture). None (the default)
    #: opens no socket; 0 binds an ephemeral port, journaled as an
    #: ``obs_started`` event. Also armed by MAGGY_TPU_OBS_PORT. One server a
    #: process: a second experiment joins the first one's listener.
    obs_port: Optional[int] = None
    #: Obs bind host: loopback, since the endpoints are unauthenticated.
    obs_host: str = "127.0.0.1"

    def resolved_obs_port(self) -> Optional[int]:
        """The obs server port to bind, or None for off: ``obs_port`` when
        set, else MAGGY_TPU_OBS_PORT (``maggy_tpu/config.py:96-104``)."""
        if self.obs_port is not None:
            return int(self.obs_port)
        return resolved_env_obs_port()

    def resolved_hb_loss_timeout(self) -> float:
        """Seconds of heartbeat silence before a runner is declared lost:
        the explicit ``hb_loss_timeout`` field when set, else
        max(hb_loss_min_s, hb_interval * hb_loss_factor) — the one home of
        this resolution (``maggy_tpu/config.py:107-117``)."""
        explicit = getattr(self, "hb_loss_timeout", None)
        if explicit is not None:
            return float(explicit)
        return max(self.hb_loss_min_s, self.hb_interval * self.hb_loss_factor)


def resolved_env_obs_port() -> Optional[int]:
    """MAGGY_TPU_OBS_PORT as an int, or None when unset, empty or not a
    number."""
    raw = os.environ.get("MAGGY_TPU_OBS_PORT", "").strip()
    if not raw:
        return None
    try:
        return int(raw)
    except ValueError:
        return None


@dataclass
class OptimizationConfig(LagomConfig):
    """Hyperparameter-optimization experiment (reference
    `experiment_config.py:25-50`).

    ``optimizer`` is a registry name ("randomsearch", "asha", "gridsearch",
    "tpe", "gp", "none") or an AbstractOptimizer instance. ``pool`` picks the
    runners: "thread" (in-process threads sharing the CUDA device), "process"
    (one spawned OS process each; ``train_fn`` must be module-level), "gpu"
    (processes pinned to ``chips_per_trial`` CUDA devices each through
    CUDA_VISIBLE_DEVICES), "elastic" (processes leased ``chips_per_budget``
    chips each out of ``total_chips``, respawned at another size when the
    next trial's budget needs it) or "remote" (agents started apart, ``python -m
    maggy_tpu_torch.runner``, JOIN through the join ticket the driver
    writes to ``<exp_dir>/runner_ticket.json``). ``num_workers`` is the
    runner count, or "auto" for one per CUDA device (not for "remote":
    agents join as they come, and the count caps their admission); the
    driver clamps it to ``num_trials``. ``fleet`` is set by ``Fleet.submit``
    (``lagom_submit``): the experiment then leases runners from the fleet
    instead of owning a pool.
    ``prefetch`` pipelines the trial hand-off: a suggester thread
    materializes the next suggestions while runners train, and a FINAL's
    reply carries the runner's next trial (``maggy_tpu/config.py:194``).
    ``hb_loss_timeout`` overrides the heartbeat-loss shape of LagomConfig.
    ``fork`` (``maggy_tpu/config.py:205-216``): an ASHA promotion, a PBT
    segment or a BO near-duplicate whose parent saved a checkpoint is
    dispatched with ``forked_from`` and ``resume_step``, the runner stages
    the parent's checkpoint into the child's trial dir, and a train
    function that takes ``ctx`` resumes there instead of re-training the
    parent's steps; False gives from-scratch promotions. ``resume``
    (``maggy_tpu/config.py:243-247``) re-enters the most recent run of this
    app id whose experiment has this ``name``: finalized trials are
    reloaded from their trial.json artifacts and never re-run, the trials
    in flight at the interruption are rebuilt from the telemetry journal
    and re-run, and a pruner's bracket state restores from its checkpoint;
    sampling optimizers (RandomSearch, TPE, GP) must carry a fixed seed."""

    num_trials: int = 1
    optimizer: Union[str, Any] = "randomsearch"
    searchspace: Optional[Searchspace] = None
    optimization_key: str = "metric"
    direction: str = "max"
    es_interval: int = constants.DEFAULT_ES_INTERVAL
    es_min: int = constants.DEFAULT_ES_MIN
    es_policy: Union[str, Any] = constants.DEFAULT_ES_POLICY
    num_workers: Union[int, str] = 1
    pool: str = "thread"
    chips_per_trial: int = 1
    seed: Optional[int] = None
    prefetch: bool = True
    hb_loss_timeout: Optional[float] = None
    # Compile-once hot path (train/warm.py, maggy_tpu/config.py:195-204):
    # runners keep each program's materialized model, optimizer and
    # captured step graphs across trials whose program identity matches
    # (model config, device, loss, swept-optimizer family, batch shape),
    # so a repeat trial skips the model's build and the step's capture.
    # State VALUES are always recomputed per trial: only memory and graphs
    # are reused. False restores the build-per-trial eager path.
    warm_start: bool = True
    fork: bool = True
    # Experiment artifact root; defaults to the environment's base dir.
    experiment_dir: Optional[str] = None
    resume: bool = False
    # Vectorized lanes (maggy_tpu/config.py:222-234, train/vmap.py): the
    # driver packs up to this many compatible suggestions (same non-float
    # params, no resume or checkpoint fork) into one block delivered to
    # one runner, whose train function, if it names ``lanes``, trains them
    # in lockstep as one vmapped step. Each lane keeps its own span,
    # metrics and FINAL. 1 (the default) is the scalar dispatch path.
    vmap_lanes: int = 1
    # Fleet mode (maggy_tpu/config.py:78-86): the fleet.FleetBinding of a
    # submission, set by Fleet.submit, never by hand.
    fleet: Any = None
    # Fleet journal-sink routing (maggy_tpu/config.py:87-96,
    # telemetry/sink.py): a fleet tenant ships its journal to the fleet's
    # sink over the shared socket, and <exp_dir>/telemetry.jsonl becomes the
    # shipper's fallback while the sink is down. Ignored without a fleet or
    # with the fleet's sink off.
    sink: bool = False
    # A torch.profiler trace per trial into <trial dir>/tensorboard/, the
    # trial's TensorBoard logdir (maggy_tpu/config.py:229-230). One trace at a time a process: a
    # thread-pool trial that finds the profiler busy runs untraced and
    # journals ``profile_skipped``.
    profile: bool = False
    # Tee the train function's print() calls into the reporter log, which
    # streams to the driver on heartbeats (maggy_tpu/config.py:231-236).
    ship_prints: bool = False
    # Multi-chip trial sizing, budget -> chip need (maggy_tpu/config.py:
    # 150-182). Two mechanisms share the declaration, chosen by the pool:
    # - pool="elastic" (int values): budget-sized chip leases; a runner
    #   exits and respawns re-pinned when its capacity does not match the
    #   next trial's need. Budgets missing from the map use chips_per_trial.
    # - pool="thread" or fleet mode (int or gang.GangSpec values): gang
    #   scheduling. The driver assembles N runners (runner = chip) into one
    #   contiguous block, dispatches the trial to the lowest-chip member as
    #   leader (ctx.gang carries the mesh axes and strategy) and holds the
    #   members until the trial releases. A bare int N is GangSpec(N).
    # A Searchspace GANG entry declares the same per trial.
    chips_per_budget: Optional[Dict[Any, Any]] = None
    # Chips the elastic pool may lease at once (None: one a CUDA device).
    total_chips: Optional[int] = None

    def __post_init__(self):
        if self.direction not in ("max", "min"):
            raise ValueError("direction must be 'max' or 'min', got {!r}".format(self.direction))
        if isinstance(self.num_workers, str) and self.num_workers != "auto":
            raise ValueError(
                "num_workers must be an int or 'auto', got {!r}".format(
                    self.num_workers))
        if self.pool == "tpu":
            raise ValueError("pool='tpu' pins TPU chips; the port pins CUDA devices "
                             "with pool='gpu'")
        if self.pool not in POOLS:
            raise ValueError("pool must be one of {}, got {!r}".format(
                ", ".join(repr(p) for p in POOLS), self.pool))
        if not isinstance(self.vmap_lanes, int) \
                or isinstance(self.vmap_lanes, bool) or self.vmap_lanes < 1:
            raise ValueError(
                "vmap_lanes must be an int >= 1 (1 = scalar dispatch), "
                "got {!r}".format(self.vmap_lanes))
        if not isinstance(self.chips_per_trial, int) or self.chips_per_trial < 1:
            raise ValueError("chips_per_trial must be an int >= 1, got {!r}".format(
                self.chips_per_trial))
        self._check_gang_declarations()

    def _check_gang_declarations(self) -> None:
        """The JAX package's gating of multi-chip declarations
        (``maggy_tpu/config.py:257-294``)."""
        if self.vmap_lanes > 1 and self.chips_per_budget is not None:
            raise ValueError(
                "vmap_lanes packs K trials onto ONE chip; gang-scheduled "
                "sweeps (chips_per_budget) size trials the other way — "
                "pick one")
        if self.chips_per_budget is not None and self.pool not in ("elastic", "thread"):
            raise ValueError(
                "chips_per_budget needs pool='elastic' (budget-sized "
                "respawnable pinned workers) or pool='thread' "
                "(gang-scheduled runner groups); got pool={!r}".format(self.pool))
        if self.chips_per_budget is not None and self.pool == "elastic":
            from maggy_tpu_torch.gang import GangSpec

            if any(isinstance(v, (GangSpec, dict)) for v in self.chips_per_budget.values()):
                raise ValueError(
                    "GangSpec chips_per_budget values gang-schedule fleet "
                    "runners and need pool='thread' (or fleet mode); the "
                    "elastic pool respawns single pinned runners from int "
                    "chip counts")
        if self.searchspace is not None:
            gang_names = [n for n in self.searchspace.names()
                          if self.searchspace.get_type(n) == "GANG"]
            if gang_names and self.pool != "thread":
                raise ValueError(
                    "a Searchspace GANG entry gang-schedules fleet runners "
                    "and needs pool='thread' (or fleet mode); got "
                    "pool={!r}".format(self.pool))
            if len(gang_names) > 1:
                raise ValueError(
                    "at most one Searchspace GANG entry per sweep (a trial "
                    "runs on one gang); got {}".format(gang_names))


@dataclass
class AblationConfig(OptimizationConfig):
    """Ablation-study experiment (``maggy_tpu/config.py:303-316``; reference
    `experiment_config.py:52-66`). ``ablation_study`` is an
    ``ablation.AblationStudy``; ``ablator`` a registry name ("loco") or an
    ``AbstractAblator``. The optimizer and early-stop fields are ignored:
    an ablation schedule is fixed and never early-stops."""

    ablation_study: Any = None
    ablator: Union[str, Any] = "loco"
    es_policy: str = "none"


#: DistributedConfig backends: local rank processes, threads, or remote
#: agents (``python -m maggy_tpu_torch.runner``).
DIST_BACKENDS = (None, "process", "thread", "remote")


@dataclass
class DistributedConfig(LagomConfig):
    """Distributed training of ONE model (``maggy_tpu/config.py:319-360``;
    reference `experiment_config.py:68-81`). The train function receives a
    ``parallel.ShardingEnv`` (the mesh, this rank's index, device and
    process groups) instead of a DDP-wrapped model.

    One worker is one rank on one device. ``backend`` None or "process"
    spawns one process a rank (a single worker runs in a thread of the
    caller, as in the JAX package), each joining one
    ``torch.distributed`` process group: NCCL when every rank has a card
    of its own, gloo when ranks share one (NCCL refuses two ranks on one
    device) or run on the CPU. "thread" runs every worker in a thread of
    this process: the barrier, the rendezvous and the FINAL averaging run,
    and each thread gets a world-1 ``ShardingEnv`` (a process holds one
    default group; the JAX package's thread mode skips
    ``jax.distributed`` too). "remote" spawns nothing: each rank is an
    agent started apart (``python -m maggy_tpu_torch.runner --ticket
    <exp_dir>/runner_ticket.json --train mod:fn``) that JOINs the driver,
    gets its partition (its rank), the world size, mesh, strategy and device
    from the JOIN reply, and joins the world at the rendezvous store worker
    0 hosts (``maggy_tpu/config.py:340-353``). The driver binds its control
    plane to ``bind_host``, 0.0.0.0 by default under "remote", and its
    ticket advertises a reachable address. ``device`` is where ranks run,
    "cuda" (a rank without a card raises) or "cpu" (the port's own field:
    JAX picks its default backend)."""

    #: Model (or model spec) forwarded to the train function.
    model: Any = None
    train_set: Any = None
    test_set: Any = None
    #: Number of ranks.
    num_workers: int = 1
    #: Logical mesh axes, e.g. {"data": 2} or {"data": 2, "seq": 2}.
    mesh_shape: Dict[str, int] = field(default_factory=dict)
    #: Parallelism strategy name: "dp", "fsdp", "tp", "dp_tp", "sp", ...
    strategy: str = "dp"
    backend: Optional[str] = None
    #: Control-plane bind host; defaults to 0.0.0.0 when backend="remote"
    #: (loopback otherwise).
    bind_host: Optional[str] = None
    #: A worker silent this many seconds fails the experiment (a dead rank
    #: wedges the world's collectives); also the process group's timeout.
    #: None -> max(hb_loss_min_s, hb_interval * hb_loss_factor).
    hb_loss_timeout: Optional[float] = None
    #: A torch.profiler trace per worker into the experiment dir.
    profile: bool = False
    experiment_dir: Optional[str] = None
    device: str = "cuda"

    def __post_init__(self):
        if self.bind_host is None and self.backend == "remote":
            self.bind_host = "0.0.0.0"
        if self.backend not in DIST_BACKENDS:
            raise ValueError("backend must be one of {}, got {!r}".format(
                DIST_BACKENDS, self.backend))
        if self.device not in ("cuda", "cpu"):
            raise ValueError("device must be 'cuda' or 'cpu', got {!r}".format(self.device))
        if not isinstance(self.num_workers, int) or self.num_workers < 1:
            raise ValueError("num_workers must be an int >= 1, got {!r}".format(
                self.num_workers))
