"""Gangs in the port (``maggy_tpu_torch/gang.py``) against ``maggy_tpu/gang.py``
on the CPU: every declaration case of ``tests/test_gang.py`` through both
packages (values and exception types), the placer's blocks and ``pack``
events over seeded random sequences, ``replay_pack``, ``reference_gang_loss``
on gloo ranks against the JAX function on the 8 virtual devices, invariant 8,
the trace's gang lanes and gang-aware goodput on the same journals, the pack
and gang chaos soaks, and a tiny BERT trained as a 2-chip "dp" gang against
the JAX Trainer on a 2-device mesh. Gang ranks run on the CPU
(``MAGGY_TPU_TORCH_DEVICE=cpu``); no rank process outlives a test."""

import dataclasses
import glob
import json
import os
import random

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import maggy_tpu.gang as jax_gang
from maggy_tpu import OptimizationConfig as JaxConfig
from maggy_tpu import Searchspace as JaxSearchspace
from maggy_tpu.chaos.harness import check_invariants as jax_check_invariants
from maggy_tpu.core.driver.optimization_driver import OptimizationDriver as JaxDriver
from maggy_tpu.core.environment import EnvSing as JaxEnvSing
from maggy_tpu.core.environment.abstractenvironment import LocalEnv as JaxLocalEnv
from maggy_tpu.models.bert import BertConfig as JaxBertConfig
from maggy_tpu.models.bert import BertEncoder as JaxBertEncoder
from maggy_tpu.optimizers.bayes.tpe import TPE as JaxTPE
from maggy_tpu.parallel import make_mesh as jax_make_mesh
from maggy_tpu.telemetry.goodput import compute_goodput as jax_goodput
from maggy_tpu.telemetry.trace import build_trace as jax_build_trace
from maggy_tpu.train import Trainer as JaxTrainer
from maggy_tpu.train import cross_entropy_loss as jax_ce
from maggy_tpu.trial import Trial as JaxTrial

import maggy_tpu_torch.gang as port_gang
import torch_runner_fns
from maggy_tpu_torch import OptimizationConfig, Searchspace, experiment
from maggy_tpu_torch.chaos import harness
from maggy_tpu_torch.chaos.harness import check_invariants
from maggy_tpu_torch.core.driver.optimization_driver import OptimizationDriver
from maggy_tpu_torch.core.environment import EnvSing, LocalEnv
from maggy_tpu_torch.fleet import agent as port_agent
from maggy_tpu_torch.models import flax_to_state_dict
from maggy_tpu_torch.optimizers.bayes.tpe import TPE
from maggy_tpu_torch.telemetry import read_events
from maggy_tpu_torch.telemetry.goodput import compute_goodput
from maggy_tpu_torch.telemetry.trace import build_trace, validate_trace
from maggy_tpu_torch.trial import Trial

pytestmark = [pytest.mark.torch, pytest.mark.timeout(120)]

PKGS = {
    "port": dict(gang=port_gang, cfg=OptimizationConfig, sp=Searchspace, driver=OptimizationDriver,
                 env=EnvSing, local=LocalEnv, trial=Trial, tpe=TPE),
    "jax": dict(gang=jax_gang, cfg=JaxConfig, sp=JaxSearchspace, driver=JaxDriver,
                env=JaxEnvSing, local=JaxLocalEnv, trial=JaxTrial, tpe=JaxTPE),
}


@pytest.fixture(autouse=True)
def cpu_gangs(monkeypatch):
    monkeypatch.setenv(port_agent.DEVICE_ENV, "cpu")
    yield
    assert port_gang.live_rank_pids() == []


# ------------------------------------------------------------ declarations


def _space(p):
    return p["sp"](lr=("DOUBLE", [0.0, 1.0]))


def _helpers(p, config):
    return p["gang"].config_declares_gangs(config), p["gang"].config_max_gang_chips(config)


def _cfg(p, **kw):
    return p["cfg"](name="g", num_trials=4, optimizer="randomsearch", direction="max",
                    num_workers=4, **kw)


def _resolve_by_type(p, tmp):
    p["env"].set_instance(p["local"](base_dir=os.path.join(tmp, "exp")))
    try:
        G = p["gang"].GangSpec
        config = _cfg(p, searchspace=p["sp"](lr=("DOUBLE", [0.0, 1.0]),
                                            topology=("GANG", [G(4, strategy="fsdp")])),
                      pool="thread", es_policy="none")
        drv = p["driver"](config, "app", 0)
        try:
            trial = p["trial"]({"lr": 0.5, "topology": G(4, strategy="fsdp").to_dict()})
            return drv._gang_mode, drv._gang_param, drv._gang_spec_for(trial).to_dict()
        finally:
            drv.stop()
    finally:
        p["env"].reset()


def _tpe_categories(p, _tmp):
    G = p["gang"].GangSpec
    sp = p["sp"](lr=("DOUBLE", [0.0, 1.0]), gang=("GANG", [G(1), G(2), G(4, strategy="fsdp")]))
    tpe = object.__new__(p["tpe"])
    tpe.searchspace = sp
    return p["tpe"]._n_categories(tpe), sp.var_types()


DECLARATIONS = {
    "default_mesh_from_strategy": lambda p, _: [
        p["gang"].GangSpec(4, strategy="fsdp").mesh, p["gang"].GangSpec(2, strategy="tp").mesh,
        p["gang"].GangSpec(1).mesh],
    "mesh_product_must_match": lambda p, _: p["gang"].GangSpec(4, mesh={"data": 2}),
    "mesh_product_matches": lambda p, _: p["gang"].GangSpec(
        4, mesh={"data": 2, "model": 2}).to_dict(),
    "composite_strategy_needs_mesh": lambda p, _: p["gang"].GangSpec(4, strategy="fsdp_tp"),
    "composite_strategy_with_mesh": lambda p, _: p["gang"].GangSpec(
        4, mesh={"fsdp": 2, "model": 2}, strategy="fsdp_tp").to_dict(),
    "invalid_strategy": lambda p, _: p["gang"].GangSpec(2, strategy="warpdrive"),
    "zero_chips": lambda p, _: p["gang"].GangSpec(0),
    "from_value_forms": lambda p, _: (lambda G, s: [
        G.from_value(s) is s, G.from_value(s.to_dict()) == s, G.from_value(2) == G(2),
        repr(G.from_value({"chips": 4, "strategy": "fsdp"}))])(
            p["gang"].GangSpec, p["gang"].GangSpec(4, strategy="fsdp")),
    "config_helpers": lambda p, _: _helpers(p, _cfg(
        p, searchspace=_space(p), chips_per_budget={1: p["gang"].GangSpec(1),
                                                    4: p["gang"].GangSpec(4, strategy="fsdp")})),
    "int_shorthand_on_thread_pool": lambda p, _: _helpers(p, _cfg(
        p, searchspace=_space(p), chips_per_budget={1: 1, 4: 4})),
    "int_sizes_on_elastic_pool": lambda p, _: _helpers(p, _cfg(
        p, searchspace=_space(p), pool="elastic", total_chips=4, chips_per_budget={1: 1, 4: 4})),
    "gang_entry_normalizes_to_dicts": lambda p, _: (lambda sp: [sp.get("gang"), _helpers(
        p, _cfg(p, searchspace=sp))])(p["sp"](lr=("DOUBLE", [0.0, 1.0]), gang=("GANG", [
            p["gang"].GangSpec(1), p["gang"].GangSpec(4, strategy="fsdp")]))),
    "gang_entry_resolved_by_type": _resolve_by_type,
    "tpe_counts_gang_categories": _tpe_categories,
    "multiple_gang_entries_rejected": lambda p, _: _cfg(
        p, searchspace=p["sp"](a=("GANG", [p["gang"].GangSpec(2)]),
                               b=("GANG", [p["gang"].GangSpec(4)])), pool="thread"),
    "gangspec_rejected_on_elastic": lambda p, _: _cfg(
        p, searchspace=_space(p), pool="elastic", total_chips=4,
        chips_per_budget={4: p["gang"].GangSpec(4, strategy="fsdp")}),
    "gang_entry_rejected_on_process_pool": lambda p, _: _cfg(
        p, searchspace=p["sp"](gang=("GANG", [p["gang"].GangSpec(2)])), pool="process"),
    "chips_per_budget_rejected_on_remote_pool": lambda p, _: _cfg(
        p, searchspace=_space(p), pool="remote", chips_per_budget={2: 2}),
    "lanes_refused_with_chips_per_budget": lambda p, _: _cfg(
        p, searchspace=_space(p), vmap_lanes=2, chips_per_budget={2: 2}),
    "gang_bad_chips_in_entry": lambda p, _: p["sp"](gang=("GANG", [{"chips": 4,
                                                                    "mesh": {"data": 3}}])),
}


def _outcome(fn, p, tmp):
    try:
        value = fn(p, tmp)
    except Exception as e:  # noqa: BLE001 - the exception type is compared
        return ("raise", type(e).__name__)
    if hasattr(value, "to_dict") and not isinstance(value, dict):
        value = value.to_dict()
    return ("ok", json.loads(json.dumps(value, default=repr)))


@pytest.mark.parametrize("case", sorted(DECLARATIONS))
def test_gang_declarations_match_jax(case, tmp_path):
    fn = DECLARATIONS[case]
    port = _outcome(fn, PKGS["port"], str(tmp_path / "port"))
    jax_out = _outcome(fn, PKGS["jax"], str(tmp_path / "jax"))
    assert port == jax_out


def test_config_keeps_the_jax_validation_messages():
    for kw in (dict(pool="process", chips_per_budget={2: 2}),
               dict(vmap_lanes=2, chips_per_budget={2: 2})):
        with pytest.raises(ValueError) as port_e:
            OptimizationConfig(**kw)
        with pytest.raises(ValueError) as jax_e:
            JaxConfig(**kw)
        assert str(port_e.value) == str(jax_e.value)


# ------------------------------------------------------------------- placer


class _Journal:
    def __init__(self):
        self.events = []

    def event(self, kind, **fields):
        self.events.append({"ev": kind, **fields})


def _placer_run(gang_mod, seed, chips):
    """A seeded sequence of reserve / release / avoid over one placer;
    returns the decisions, the pack events and a journal of them with
    timed trial edges for replay_pack."""
    rng = random.Random(seed)
    journal = _Journal()
    placer = gang_mod.GangPlacer(chips, telemetry=journal)
    decisions, live, t = [], [], 0.0
    for step in range(40):
        t += rng.random()
        if live and rng.random() < 0.35:
            key = live.pop(rng.randrange(len(live)))
            placer.release(key, reason=rng.choice(["finalized", "member_lost"]))
            decisions.append(("release", key))
            continue
        key = "g{}".format(step)
        size = rng.choice([s for s in (1, 2, 3, 4, 8) if s <= chips])
        free = {c for c in range(chips) if rng.random() < 0.6}
        avoid = {rng.randrange(chips)} if rng.random() < 0.3 else None
        block = placer.reserve(key, size, free, avoid=avoid)
        decisions.append(("reserve", key, size, block, placer.owner_of(0),
                          sorted(placer.reserved_chips())))
        if block is not None:
            live.append(key)
            if rng.random() < 0.5:
                # A sticky reservation answers again with its block.
                assert placer.reserve(key, size, set()) == block
    decisions.append(placer.snapshot())
    # The pack events with times, and the gang and 1-chip trial edges a
    # driver journals around them.
    timed, t = [], 0.0
    for i, ev in enumerate(journal.events):
        t += 0.25
        timed.append(dict(ev, t=t))
        if ev.get("op") == "reserve":
            timed.append({"ev": "trial", "t": t + 0.1, "trial": ev["gang"],
                          "phase": "gang_assembled", "chips": ev["block"]})
            timed.append({"ev": "trial", "t": t + 0.2, "trial": "s{}".format(i),
                          "phase": "running"})
        elif ev.get("op") == "release":
            timed.append({"ev": "trial", "t": t + 0.1, "trial": ev["gang"],
                          "phase": "gang_released"})
            timed.append({"ev": "trial", "t": t + 0.15, "trial": "s{}".format(i - 1),
                          "phase": "finalized"})
    return decisions, journal.events, timed


@pytest.mark.parametrize("chips", [8, 16])
def test_placer_blocks_and_pack_events_match_jax(chips):
    stalls = 0
    for seed in range(30):
        port = _placer_run(port_gang, seed, chips)
        ref = _placer_run(jax_gang, seed, chips)
        assert port[0] == ref[0], seed
        assert port[1] == ref[1], seed
        assert port_gang.replay_pack(ref[2]) == jax_gang.replay_pack(ref[2]), seed
        stalls += port[0][-1]["stalls"]
    # The sequences reach every branch: fragmentation stalls included.
    assert stalls > 0


def test_windows_match_jax():
    rng = random.Random(3)
    for _ in range(200):
        total, size = rng.choice([8, 16]), rng.choice([1, 2, 4, 8])
        taken = {c for c in range(total) if rng.random() < 0.3}
        assert port_gang.aligned_windows(total, size, taken) == \
            jax_gang.aligned_windows(total, size, taken)
        assert port_gang.contiguous_windows(total, size, taken) == \
            jax_gang.contiguous_windows(total, size, taken)


# --------------------------------------------------- the computation itself


@pytest.mark.parametrize("spec", [(1, "dp"), (2, "dp"), (4, "fsdp")])
def test_reference_gang_loss_on_gloo_ranks_matches_jax(spec, tmp_path):
    chips, strategy = spec
    gs = port_gang.GangSpec(chips, strategy=strategy)
    lrs = (0.05, 0.2)
    ref = [jax_gang.reference_gang_loss(lr, jax_gang.GangSpec(chips, strategy=strategy)
                                        .to_dict()) for lr in lrs]
    if chips == 1:
        ranks = [[port_gang.reference_gang_loss(lr, gs.to_dict()) for lr in lrs]]
    else:
        ranks = torch_runner_fns.run_world(torch_runner_fns.gang_loss_rank, chips,
                                           str(tmp_path / "world"), args=(gs.to_dict(), lrs))
    for losses in ranks:
        for port, jax_loss in zip(losses, ref):
            assert abs(port - jax_loss) <= 1e-5


# ------------------------------------------------- telemetry on one journal


def _chaos_events(requeues=1, released=True, reassembled=True, finalized=True):
    """``tests/test_gang.py:602-625``'s revocation journal."""
    evs = [
        {"ev": "trial", "t": 0.0, "trial": "g", "phase": "queued"},
        {"ev": "trial", "t": 1.0, "trial": "g", "phase": "gang_assembled", "partition": 0,
         "members": [0, 1, 2, 3]},
        {"ev": "chaos", "t": 1.1, "kind": "kill_gang_member", "trial": "g", "partition": 1,
         "leader": 0},
    ]
    if released:
        evs.append({"ev": "trial", "t": 1.5, "trial": "g", "phase": "gang_released",
                    "members": [0, 1, 2, 3]})
    for i in range(requeues):
        evs.append({"ev": "trial", "t": 1.6 + i * 0.1, "trial": "g", "phase": "requeued",
                    "partition": 1, "reason": "gang_member_lost"})
    if reassembled:
        evs.append({"ev": "trial", "t": 2.0, "trial": "g", "phase": "gang_assembled",
                    "partition": 2, "members": [2, 3, 4, 5]})
    if finalized:
        evs.append({"ev": "trial", "t": 3.0, "trial": "g", "phase": "finalized",
                    "partition": 2})
    evs.append({"ev": "experiment", "t": 4.0, "phase": "finalized"})
    return evs


CHAOS_CASES = {
    "clean_revocation": _chaos_events(),
    "over_requeue": _chaos_events(requeues=2),
    "missing_release": _chaos_events(released=False),
    "missing_reassembly": _chaos_events(reassembled=False),
    "race_lost_to_final": [
        {"ev": "trial", "t": 0.0, "trial": "g", "phase": "queued"},
        {"ev": "trial", "t": 1.0, "trial": "g", "phase": "gang_assembled", "partition": 0,
         "members": [0, 1]},
        {"ev": "chaos", "t": 1.1, "kind": "kill_gang_member", "trial": "g", "partition": 1,
         "leader": 0},
        {"ev": "trial", "t": 1.2, "trial": "g", "phase": "finalized", "partition": 0},
        {"ev": "trial", "t": 1.2, "trial": "g", "phase": "gang_released", "members": [0, 1]},
        {"ev": "experiment", "t": 2.0, "phase": "finalized"}],
}
CHAOS_EXPECT = {"clean_revocation": ("revoked", None), "over_requeue": (None, "over-requeue"),
                "missing_release": (None, "not released"),
                "missing_reassembly": (None, "never reassembled"),
                "race_lost_to_final": ("completed_before_detection", None)}


@pytest.mark.parametrize("case", sorted(CHAOS_CASES))
def test_invariant_8_matches_jax(case):
    kw = dict(requeue_bound_s=10.0, stall_flag_bound_s=None)
    port = check_invariants(CHAOS_CASES[case], **kw)
    ref = jax_check_invariants(CHAOS_CASES[case], **kw)
    assert port["violations"] == ref["violations"]
    assert port["gang_revocations"] == ref["gang_revocations"]
    outcome, violation = CHAOS_EXPECT[case]
    if outcome is not None:
        assert port["ok"] and port["gang_revocations"][0]["outcome"] == outcome
    else:
        assert any(violation in v for v in port["violations"])


TRACE_CASES = {
    "gang_band_and_pack_markers": [
        {"ev": "pack", "t": 0.0, "op": "init", "chips": 8},
        {"ev": "pack", "t": 0.1, "op": "reserve", "gang": "g1", "block": [0, 1, 2, 3]},
        {"ev": "trial", "t": 0.2, "trial": "g1", "phase": "assigned", "partition": 0},
        {"ev": "trial", "t": 0.2, "trial": "g1", "phase": "gang_assembled", "partition": 0,
         "members": [0, 1, 2, 3], "chips": [0, 1, 2, 3], "strategy": "fsdp"},
        {"ev": "trial", "t": 0.3, "trial": "g1", "phase": "running", "partition": 0},
        {"ev": "trial", "t": 0.9, "trial": "g1", "phase": "finalized", "partition": 0},
        {"ev": "trial", "t": 0.9, "trial": "g1", "phase": "gang_released", "partition": 0,
         "members": [0, 1, 2, 3]}],
    "open_gang_closes_at_journal_end": [
        {"ev": "trial", "t": 0.0, "trial": "g", "phase": "assigned", "partition": 0},
        {"ev": "trial", "t": 0.0, "trial": "g", "phase": "gang_assembled", "partition": 0,
         "members": [0, 1], "chips": [0, 1], "strategy": "dp"},
        {"ev": "trial", "t": 2.0, "trial": "x", "phase": "queued"}],
}


@pytest.mark.parametrize("case", sorted(TRACE_CASES))
def test_trace_gang_lanes_match_jax(case):
    events = TRACE_CASES[case]
    port, ref = build_trace(events), jax_build_trace(events)
    assert port["traceEvents"] == ref["traceEvents"]
    bands = [e for e in port["traceEvents"] if e.get("cat") == "gang" and e.get("ph") == "X"]
    assert len(bands) == (4 if case.startswith("gang_band") else 2)
    assert all(b["dur"] >= 1 for b in bands)
    if case.startswith("gang_band"):
        assert validate_trace(port) > 0
        assert {b["pid"] for b in bands} == {1, 2, 3, 4}
        assert len([e for e in port["traceEvents"] if e.get("cat") == "pack"]) == 2


# -------------------------------------------------------------------- soaks


def test_pack_soak_meets_the_jax_gates_and_its_journal_reads_the_same(tmp_path):
    """``tests/test_gang.py:838-855``'s gates on the port's soak (8 thread
    runners, 4-chip fsdp gangs of 4 rank processes each), and its journal
    through both packages' replay_pack, goodput and trace."""
    report = port_gang.run_pack_soak(base_dir=str(tmp_path / "pack"))
    assert report["ok"], report["violations"]
    assert report["pack"]["gangs_assembled"] >= 1
    assert report["pack"]["chip_seconds_utilization"] >= 0.7
    assert report["parity"] and all(p["abs_err"] <= 1e-4 for p in report["parity"])
    events = read_events(report["journal"])
    assert port_gang.replay_pack(events) == jax_gang.replay_pack(events) == report["pack"]
    port_gp, jax_gp = compute_goodput(events), jax_goodput(events)
    assert json.dumps(port_gp, sort_keys=True) == json.dumps(jax_gp, sort_keys=True)
    assert port_gp["gangs"] >= 1 if "gangs" in port_gp else True
    assert build_trace(events)["traceEvents"] == jax_build_trace(events)["traceEvents"]
    # Every rank a gang started was a process of its own, gone by now.
    assert len(port_gang.RANK_PIDS) >= 4 * report["pack"]["gangs_assembled"]


def test_gang_chaos_soak_revokes_once(tmp_path):
    """A short ``run_gang_soak``: one member of the first 2-chip gang
    killed mid-trial; the whole lease is revoked, the trial requeued once
    with reason gang_member_lost and reassembled, and no rank survives."""
    report = harness.run_gang_soak(num_trials=4, workers=4, gang_chips=2,
                                   base_dir=str(tmp_path / "soak"))
    assert report["ok"], report["violations"]
    revoked = [r for r in report["gang_revocations"] if r["outcome"] == "revoked"]
    assert len(revoked) == 1 and revoked[0]["requeues"] == 1
    assert report["gang_rank_survivors"] == []


# ------------------------------------------------------- the slice as a whole


def _bert_configs():
    fields = dict(vocab_size=64, hidden_dim=64, intermediate_dim=128, num_layers=2, num_heads=1,
                  max_seq_len=64, num_classes=2, dropout=0.0)
    return JaxBertConfig(dtype=jnp.float32, **fields), fields


def test_tiny_bert_gang_matches_the_jax_gang(tmp_path, monkeypatch):
    """A tiny BERT (2 layers, hidden 64, the plain attention on the CPU)
    trained 3 steps by a 2-chip "dp" gang through the port's lagom, against
    the same model on a 2-device "data" mesh in the JAX Trainer, from the
    same Flax weights (``flax_to_state_dict``): losses within 1e-4."""
    jcfg, fields = _bert_configs()
    lr = 1e-3
    mesh = jax_make_mesh({"data": 2}, devices=jax.devices()[:2])
    jtrainer = JaxTrainer(JaxBertEncoder(jcfg), optax.adamw(lr),
                          lambda logits, b: jax_ce(logits, b["labels"]), mesh, warm_start=False)
    jtrainer.init(jax.random.key(0), (jnp.ones((1, torch_runner_fns.GANG_BERT_S), jnp.int32),))
    params = jax.tree_util.tree_map(np.asarray, nn.meta.unbox(jtrainer.variables)["params"])
    ref = []
    for step in range(3):
        tokens, mask, labels = torch_runner_fns.gang_bert_batch(step)
        ref.append(float(jtrainer.step(jtrainer.place_batch(
            {"inputs": (tokens.astype(np.int32), mask), "labels": labels}))))
    state = str(tmp_path / "bert_state.pt")
    torch.save(flax_to_state_dict(params), state)
    out = tmp_path / "ranks"
    out.mkdir()
    monkeypatch.setenv("MAGGY_TEST_GANG_BERT", json.dumps(
        {"state": state, "fields": fields, "out": str(out), "lr": lr}))
    result = experiment.lagom(torch_runner_fns.train_gang_bert, OptimizationConfig(
        name="bert_gang", num_trials=1, optimizer="randomsearch",
        searchspace=Searchspace(x=("DOUBLE", [0.0, 1.0]),
                                gang=("GANG", [port_gang.GangSpec(2, strategy="dp")])),
        direction="min", num_workers=2, pool="thread", hb_interval=0.05, es_policy="none",
        seed=0, experiment_dir=str(tmp_path / "exp")))
    assert result["num_trials"] == 1
    ranks = [json.load(open(out / "rank{}.json".format(r))) for r in range(2)]
    for rank in ranks:
        assert rank["world"] == 2 and rank["backend"] == "gloo"
        np.testing.assert_allclose(rank["losses"], ref, rtol=0, atol=1e-4)
    assert ranks[0]["losses"] == ranks[1]["losses"]
    assert len({r["pid"] for r in ranks} | {os.getpid()}) == 3
    assert result["best_val"] == pytest.approx(ranks[0]["losses"][-1], abs=1e-6)
    (journal,) = glob.glob(str(tmp_path / "exp" / "*" / "telemetry.jsonl"))
    phases = [e["phase"] for e in read_events(journal) if e["ev"] == "trial"]
    assert phases.count("gang_assembled") == phases.count("gang_released") == 1


def test_a_failed_rank_fails_its_trial_and_leaves_no_rank(tmp_path):
    """A rank that raises kills its gang's other ranks, and the trial
    finalizes as an error."""
    result = experiment.lagom(torch_runner_fns.train_gang_failing, OptimizationConfig(
        name="gang_fail", num_trials=1, optimizer="randomsearch",
        searchspace=Searchspace(x=("DOUBLE", [0.0, 1.0]),
                                gang=("GANG", [port_gang.GangSpec(2)])),
        num_workers=2, pool="thread", hb_interval=0.05, es_policy="none", seed=0,
        experiment_dir=str(tmp_path)))
    assert result["best_val"] is None
    (trial,) = glob.glob(str(tmp_path / "*" / "*" / "trial.json"))
    assert json.load(open(trial))["status"] == "ERROR"
    logs = "".join(open(p).read() for p in glob.glob(str(tmp_path / "*" / "executor_*.log")))
    assert "gang rank 1" in logs and "rank 1 refuses" in logs


def test_a_gang_trial_is_profiled_and_ships_its_prints(tmp_path):
    """``profile`` and ``ship_prints`` hold for a gang trial as for a 1-chip
    one: rank 0 traces the trial into its trial dir, and its prints (not
    rank 1's) reach the leader's log."""
    result = experiment.lagom(torch_runner_fns.train_gang_printing, OptimizationConfig(
        name="gang_traced", num_trials=1, optimizer="randomsearch",
        searchspace=Searchspace(x=("DOUBLE", [0.0, 1.0]),
                                gang=("GANG", [port_gang.GangSpec(2)])),
        num_workers=2, pool="thread", hb_interval=0.05, es_policy="none", seed=0,
        profile=True, ship_prints=True, experiment_dir=str(tmp_path)))
    assert result["num_trials"] == 1 and result["best_val"] is not None
    (trace,) = glob.glob(str(tmp_path / "*" / "*" / "tensorboard" / "*.pt.trace.json"))
    with open(trace) as f:
        assert json.load(f)["traceEvents"]
    logs = "".join(open(p).read() for p in glob.glob(str(tmp_path / "*" / "executor_*.log")))
    assert "gang rank 0 prints" in logs and "gang rank 1 prints" not in logs


def test_gang_config_dataclass_fields_match_jax():
    port = {f.name for f in dataclasses.fields(OptimizationConfig)}
    assert {"chips_per_budget", "total_chips"} <= port
    assert OptimizationConfig().total_chips is None and JaxConfig().total_chips is None
