"""The port's pipelined trial hand-off and the controllers behind it: the
split report/suggest/recycle contract, ASHA's schedule_version
invalidation, the driver's prefetch queue, the FINAL-reply piggyback over a
real server and client, the suggester's failure contract, an expensive
controller that must never suggest on the RPC thread, and the Hyperband,
GridSearch and SingleRun schedules against the JAX package's."""

import json
import math
import os
import tempfile
import threading
import time

import numpy as np
import pytest

from maggy_tpu.optimizers import GridSearch as JaxGridSearch
from maggy_tpu.optimizers import RandomSearch as JaxRandomSearch
from maggy_tpu.optimizers import SingleRun as JaxSingleRun
from maggy_tpu.pruner.hyperband import Hyperband as JaxHyperband
from maggy_tpu.searchspace import Searchspace as JaxSearchspace
from maggy_tpu_torch import OptimizationConfig, experiment
from maggy_tpu_torch.core.driver.optimization_driver import (CONTROLLER_REGISTRY,
                                                              OptimizationDriver)
from maggy_tpu_torch.core.environment import EnvSing, LocalEnv
from maggy_tpu_torch.core.rpc import Client
from maggy_tpu_torch.optimizers import (AbstractOptimizer, Asha, GridSearch, RandomSearch,
                                        SingleRun)
from maggy_tpu_torch.pruner import Hyperband
from maggy_tpu_torch.searchspace import Searchspace
from maggy_tpu_torch.trial import Trial

pytestmark = pytest.mark.torch


def _space():
    return Searchspace(lr=("DOUBLE", [0.0, 1.0]))


def _wire(opt, num_trials, space=None):
    """Driver-side controller wiring."""
    opt.searchspace = space or _space()
    opt.num_trials = num_trials
    opt.trial_store = {}
    opt.final_store = []
    opt.direction = "max"
    opt._initialize()
    return opt


def _finalize(opt, trial, metric):
    """The driver's FINAL flow: store moves, then report."""
    trial.final_metric = metric
    trial.status = Trial.FINALIZED
    opt.trial_store.pop(trial.trial_id, None)
    opt.final_store.append(trial)
    opt.report(trial)


# ---------------------------------------------------------------- contract


class TestSplitContract:
    def test_get_suggestion_equals_report_plus_suggest(self):
        a = _wire(RandomSearch(seed=5), 4)
        b = _wire(RandomSearch(seed=5), 4)
        legacy = [a.get_suggestion().params for _ in range(4)]
        split = []
        for _ in range(4):
            t = b.suggest()
            b.report(t)
            split.append(t.params)
        assert legacy == split

    def test_builtin_controllers_support_prefetch(self):
        from maggy_tpu_torch.optimizers.bayes import GP, TPE

        for opt in (RandomSearch(seed=0), GridSearch(), SingleRun(), TPE(seed=0), GP(seed=0),
                    Asha(reduction_factor=2, resource_min=1, resource_max=2)):
            assert opt.supports_prefetch()

    def test_wholesale_get_suggestion_override_opts_out(self):
        class Legacy(AbstractOptimizer):
            def initialize(self):
                pass

            def get_suggestion(self, trial=None):
                return None

        assert not Legacy().supports_prefetch()

    def test_contractless_subclass_rejected_at_construction(self):
        class Empty(AbstractOptimizer):
            def initialize(self):
                pass

        with pytest.raises(TypeError, match="suggest"):
            Empty()

    @pytest.mark.parametrize("kind", ["randomsearch", "gridsearch", "singlerun"])
    def test_recycle_preserves_schedule(self, kind):
        opt = {"randomsearch": lambda: _wire(RandomSearch(seed=9), 3),
               "gridsearch": lambda: _wire(GridSearch(), 3, Searchspace(
                   units=("DISCRETE", [8, 16, 32]))),
               "singlerun": lambda: _wire(SingleRun(), 3)}[kind]()
        first = opt.suggest()
        opt.recycle(first)
        again = opt.suggest()
        assert again.params == first.params  # front of the schedule
        rest = [opt.suggest() for _ in range(2)]
        assert None not in rest and opt.suggest() is None

    def test_registry_resolves_every_name(self):
        assert set(CONTROLLER_REGISTRY) == {"randomsearch", "gridsearch", "asha", "tpe", "gp",
                                            "none"}
        from maggy_tpu_torch.optimizers.bayes import GP, TPE

        for name, cls in (("tpe", TPE), ("gp", GP), ("none", SingleRun), ("asha", Asha),
                          ("gridsearch", GridSearch), ("randomsearch", RandomSearch)):
            assert isinstance(CONTROLLER_REGISTRY[name](seed=0), cls)
        assert OptimizationConfig().prefetch is True


class TestAshaInvalidation:
    """A promotion (or done flip) decided by a FINAL bumps schedule_version
    so the driver drops stale prefetched samples before dispatch, and the
    next suggest() returns the promotion."""

    def _asha(self):
        opt = _wire(Asha(reduction_factor=2, resource_min=1, resource_max=2, seed=1), 2)
        t1 = opt.suggest()
        opt.trial_store[t1.trial_id] = t1
        t2 = opt.suggest()
        opt.trial_store[t2.trial_id] = t2
        return opt, t1, t2

    def test_promotion_bumps_version_and_wins_next_suggest(self):
        opt, t1, t2 = self._asha()
        v0 = opt.schedule_version
        _finalize(opt, t1, 0.9)
        assert opt.schedule_version == v0  # k = 1 // 2 = 0: nothing promotable
        _finalize(opt, t2, 0.5)
        assert opt.schedule_version > v0
        nxt = opt.suggest()
        assert nxt.info_dict["sample_type"] == "promoted"
        assert nxt.info_dict["parent"] == t1.trial_id  # 0.9 wins (max)

    def test_top_rung_final_flips_done(self):
        opt, t1, t2 = self._asha()
        _finalize(opt, t1, 0.9)
        _finalize(opt, t2, 0.5)
        promoted = opt.suggest()
        opt.trial_store[promoted.trial_id] = promoted
        v = opt.schedule_version
        _finalize(opt, promoted, 0.95)
        assert opt.schedule_version > v
        assert opt.suggest() is None

    def test_recycled_promotion_is_rederivable(self):
        opt, t1, t2 = self._asha()
        _finalize(opt, t1, 0.9)
        _finalize(opt, t2, 0.5)
        promoted = opt.suggest()
        assert t1.trial_id in opt.promoted[0]
        opt.recycle(promoted)
        assert t1.trial_id not in opt.promoted.get(0, [])
        again = opt.suggest()
        assert again.info_dict["sample_type"] == "promoted"
        assert again.info_dict["parent"] == t1.trial_id


# ------------------------------------------------------------------ driver


@pytest.fixture
def env(tmp_path):
    EnvSing.set_instance(LocalEnv(base_dir=str(tmp_path / "exp")))
    yield
    EnvSing.reset()


def _config(**kw):
    base = dict(name="prefetch_drv", num_trials=4, optimizer="randomsearch",
                searchspace=_space(), direction="max", num_workers=2, seed=2,
                es_policy="none")
    base.update(kw)
    return OptimizationConfig(**base)


@pytest.fixture
def driver(env, monkeypatch):
    # No background suggester: these tests drive the refill by hand.
    monkeypatch.setattr(OptimizationDriver, "_suggester_loop", lambda self: None)
    drv = OptimizationDriver(_config(), "app", 0)
    yield drv
    drv.stop()


class TestDriverPrefetch:
    def test_capacity_follows_live_runners(self, driver):
        assert driver._prefetch_enabled
        assert driver._prefetch_capacity() == 0  # nobody registered
        driver.server.reservations.add({"partition_id": 0})
        assert driver._prefetch_capacity() == 1
        driver.server.reservations.add({"partition_id": 1})
        assert driver._prefetch_capacity() == 2
        driver.server.reservations.mark_released(1)
        assert driver._prefetch_capacity() == 1

    def test_refill_admits_into_store_and_queue(self, driver):
        driver.server.reservations.add({"partition_id": 0})
        assert driver._refill_prefetch()
        assert len(driver._prefetched) == 1
        trial = driver._prefetched[0]
        assert driver._trial_store[trial.trial_id] is trial
        assert not driver._refill_prefetch()  # at capacity: no suggest() call
        assert driver.pipeline_snapshot()["suggest_threads"] == {
            threading.current_thread().name: 1}

    def test_invalidation_recycles_through_controller(self, driver):
        driver.server.reservations.add({"partition_id": 0})
        assert driver._refill_prefetch()
        trial = driver._prefetched[0]
        buf_before = len(driver.controller.config_buffer)
        driver.controller.schedule_version += 1
        with driver._sched_lock:
            driver._invalidate_stale_prefetch()
        assert not driver._prefetched
        assert trial.trial_id not in driver._trial_store
        assert len(driver.controller.config_buffer) == buf_before + 1
        assert driver.pipeline_snapshot()["invalidated"] == 1

    def test_dispatch_pops_prefetched_without_dup_warning(self, driver):
        driver.server.reservations.add({"partition_id": 0})
        assert driver._refill_prefetch()
        trial = driver._prefetched[0]
        driver._assign_next(0, None)
        assert driver.server.reservations.get_assigned_trial(0) == trial.trial_id
        assert not driver._prefetched
        log = os.path.join(driver.exp_dir, "maggy.log")
        assert not os.path.exists(log) or "WARNING" not in open(log).read()

    def test_asha_promotion_invalidates_prefetched_sample(self, env, monkeypatch):
        """Driver level: a FINAL that makes a promotion available drops the
        prefetched rung-0 sample, the promotion is dispatched next, and the
        rung-0 count is kept (the sample is re-drawn later)."""
        monkeypatch.setattr(OptimizationDriver, "_suggester_loop", lambda self: None)
        drv = OptimizationDriver(_config(num_trials=4, optimizer=Asha(2, 1, 2, seed=0)), "app", 0)
        try:
            res = drv.server.reservations
            for pid in (0, 1):
                res.add({"partition_id": pid})
                drv._assign_next(pid, None)
            running = [drv.get_trial(res.get_assigned_trial(pid)) for pid in (0, 1)]
            assert drv._refill_prefetch() and drv._refill_prefetch()
            first, stale = drv._prefetched
            for pid, (trial, metric) in enumerate(zip(running, (0.2, 0.8))):
                res.clear_trial_if(pid, trial.trial_id)
                assert drv.process_final_inline({"partition_id": pid, "trial_id": trial.trial_id,
                                                 "value": metric})
            # The first FINAL dispatched a prefetched sample; the second made
            # a promotion available: the other sample was dropped and the
            # promotion is the next hand-off.
            assert res.get_assigned_trial(0) == first.trial_id
            promoted = drv.get_trial(res.get_assigned_trial(1))
            assert promoted.info_dict["sample_type"] == "promoted"
            assert promoted.info_dict["parent"] == running[1].trial_id
            assert stale.trial_id not in drv._trial_store and not drv._prefetched
            assert drv.pipeline_snapshot()["invalidated"] == 1
            assert drv._refill_prefetch()  # the fourth rung-0 sample, drawn anew
            assert drv._prefetched[0].info_dict["rung"] == 0
            assert not drv._refill_prefetch()  # 4 rung-0 samples: IDLE
        finally:
            drv.stop()


def _first(drv, client):
    """Register the runner and hand it its first trial (no worker thread
    runs in these tests: the REG is answered here)."""
    client.register()
    drv._assign_next(0, None)
    return client.get_suggestion()[0]


class TestFinalPiggyback:
    """The wire-level fast path against a real server and client."""

    @pytest.fixture
    def live(self, env):
        drv = OptimizationDriver(_config(num_trials=3, num_workers=1, seed=4), "app", 0)
        addr = drv.server.start()
        client = Client(addr, 0, 10.0, drv.server.secret_hex)
        yield drv, client
        client.stop()
        drv.stop()

    def test_final_reply_carries_next_trial(self, live):
        drv, client = live
        tid = _first(drv, client)
        resp = client._request({"type": "FINAL", "trial_id": tid, "value": 1.0, "logs": []})
        assert resp["type"] == "TRIAL" and resp["trial_id"] != tid
        snap = drv.pipeline_snapshot()
        assert snap["prefetch_hits"] == 1 and snap["prefetch_misses"] == 0
        assert len(snap["handoff_ms"]["0"]) == 1

    def test_last_final_replies_gstop_inline(self, live):
        drv, client = live
        tid = _first(drv, client)
        served = set()
        for _ in range(3):
            assert tid is not None and tid not in served
            served.add(tid)
            resp = client._request({"type": "FINAL", "trial_id": tid, "value": 1.0, "logs": []})
            if resp["type"] == "GSTOP":
                break
            assert resp["type"] == "TRIAL"
            tid = resp["trial_id"]
        assert len(served) == 3 and resp["type"] == "GSTOP"
        assert drv.experiment_done

    def test_retried_final_reserves_undelivered_assignment(self, live):
        drv, client = live
        tid = _first(drv, client)
        first = client._request({"type": "FINAL", "trial_id": tid, "value": 1.0, "logs": []})
        retry = client._request({"type": "FINAL", "trial_id": tid, "value": 1.0, "logs": []})
        assert first["type"] == retry["type"] == "TRIAL"
        assert retry["trial_id"] == first["trial_id"]
        assert drv.pipeline_snapshot()["prefetch_hits"] == 1

    def test_lock_timeout_fallback_counts_as_miss(self, live):
        drv, client = live
        tid = _first(drv, client)
        with drv._sched_lock:  # a suggester mid-fit
            resp = client._request({"type": "FINAL", "trial_id": tid, "value": 1.0, "logs": []})
        assert resp["type"] == "OK"
        snap = drv.pipeline_snapshot()
        assert snap["lock_fallbacks"] == 1 and snap["prefetch_misses"] == 1

    def test_prefetch_off_restores_ok_reply(self, env):
        drv = OptimizationDriver(_config(num_trials=3, num_workers=1, seed=4, prefetch=False),
                                 "app", 0)
        try:
            assert not drv._prefetch_enabled and drv._suggester_thread is None
            addr = drv.server.start()
            client = Client(addr, 0, 10.0, drv.server.secret_hex)
            tid = _first(drv, client)
            resp = client._request({"type": "FINAL", "trial_id": tid, "value": 1.0, "logs": []})
            assert resp["type"] == "OK"  # next work via GET polling
            client.stop()
        finally:
            drv.stop()


class TestPipelineHardening:
    def test_suggester_exception_ends_experiment(self, env):
        class Broken(RandomSearch):
            def suggest(self):
                raise RuntimeError("controller bug")

        drv = OptimizationDriver(_config(num_trials=3, optimizer=Broken(seed=1), num_workers=1),
                                 "app", 0)
        try:
            assert drv._prefetch_enabled
            drv.server.reservations.add({"partition_id": 0})
            drv._suggest_wake.set()
            deadline = time.monotonic() + 5
            while drv.exception is None and time.monotonic() < deadline:
                time.sleep(0.01)
            assert isinstance(drv.exception, RuntimeError)
            assert drv.experiment_done
        finally:
            drv.stop()


class SlowSearch(RandomSearch):
    """A random search that claims a model fit: suggest() sleeps and
    records the thread it ran on."""

    SUGGEST_COST = "expensive"

    def __init__(self, delay, **kw):
        super().__init__(**kw)
        self.delay = delay
        self.threads = []
        self.inside = threading.Event()

    def suggest(self):
        self.threads.append(threading.current_thread().name)
        self.inside.set()
        time.sleep(self.delay)
        self.inside.clear()
        return super().suggest()


def test_expensive_suggest_never_blocks_the_rpc_thread(env):
    """While the suggester sleeps inside suggest() holding the schedule
    lock, a runner's METRIC is answered at once and its FINAL falls back
    after the bounded lock wait instead of fitting on the RPC thread."""
    opt = SlowSearch(1.0, seed=0)
    drv = OptimizationDriver(_config(num_trials=4, optimizer=opt, num_workers=1), "app", 0)
    addr = drv.server.start()
    client = Client(addr, 0, 10.0, drv.server.secret_hex)
    try:
        tid = _first(drv, client)
        # Handing out the first trial emptied the queue: the suggester is
        # now refilling it, inside suggest() for a second.
        assert opt.inside.wait(5)
        t0 = time.monotonic()
        reply = client._request({"type": "METRIC", "trial_id": tid, "value": 0.5, "step": 0,
                                 "logs": []})
        metric_s = time.monotonic() - t0
        final = client._request({"type": "FINAL", "trial_id": tid, "value": 0.5, "logs": []})
        final_s = time.monotonic() - t0
        assert reply["type"] == "OK" and metric_s < 0.3
        assert final["type"] == "OK" and final_s < 0.5  # fell back, not fitted inline
        assert drv.pipeline_snapshot()["lock_fallbacks"] == 1
        assert "rpc-server" not in opt.threads
    finally:
        client.stop()
        drv.stop()


def _sleepy_train(lr, reporter):
    for step in range(3):
        time.sleep(0.01)
        reporter.broadcast(lr * (step + 1), step=step)
    return {"metric": lr}


@pytest.mark.parametrize("prefetch", [True, False])
def test_expensive_sweep_suggests_off_the_rpc_thread(prefetch):
    """A whole sweep with a slow expensive controller finishes its schedule,
    and no suggest() ran on the RPC server's thread, with prefetch on or
    off."""
    opt = SlowSearch(0.05, seed=3)
    result = experiment.lagom(_sleepy_train, _config(
        name="slow", num_trials=6, optimizer=opt, hb_interval=0.05, prefetch=prefetch,
        experiment_dir=tempfile.mkdtemp()))
    pipe = result["pipeline"]
    assert result["num_trials"] == 6
    assert opt.threads and "rpc-server" not in opt.threads
    assert "rpc-server" not in pipe["suggest_threads"]
    assert sum(len(v) for v in pipe["handoff_ms"].values()) == 4  # 6 trials, 2 runners
    if prefetch:
        assert len(pipe["suggest_ms"]["prefetch"]) >= 1
    else:
        assert pipe["suggest_ms"]["prefetch"] == [] and pipe["prefetch_hits"] == 0


# ---------------------------------------------- schedules against the JAX package


@pytest.mark.parametrize("min_b,max_b,eta", [(1, 9, 3), (1, 243, 3), (1, 16, 2), (2, 50, 3)])
def test_hyperband_bracket_plans_match_jax(min_b, max_b, eta):
    ours = Hyperband(lambda: {}, min_budget=min_b, max_budget=max_b, eta=eta)
    ref = JaxHyperband(lambda: {}, min_budget=min_b, max_budget=max_b, eta=eta)
    assert ours.max_sh_rungs == ref.max_sh_rungs
    assert ours.budgets == ref.budgets
    assert ours.num_trials() == ref.num_trials()
    assert [ours._bracket_plan(i) for i in range(ours.max_sh_rungs)] == \
        [ref._bracket_plan(i) for i in range(ref.max_sh_rungs)]
    if (min_b, max_b, eta) == (1, 243, 3):
        assert ours.max_sh_rungs == 6  # log(243, 3) == 4.9999... would drop a rung


def _run_schedule(opt, initialize, fail_every=0, workers=2):
    """Drive a controller as the driver does (``workers`` in flight, the
    oldest finalizing first, every ``fail_every``-th trial an ERROR that the
    pruner must re-issue). Returns (params, sample_type, parent) in order."""
    initialize()
    order, in_flight, n = [], [], 0
    while True:
        while len(in_flight) < workers:
            t = opt.suggest()
            if t in (None, "IDLE"):
                break
            opt.trial_store[t.trial_id] = t
            in_flight.append(t)
            order.append((dict(t.params), t.info_dict["sample_type"],
                          t.info_dict.get("parent")))
        if not in_flight:
            return order
        t = in_flight.pop(0)
        n += 1
        opt.trial_store.pop(t.trial_id)
        if fail_every and n % fail_every == 0 and t.params.get("budget", 1) == 1:
            t.status = Trial.ERROR
            opt.final_store.append(t)
            opt.pruner.report_failure(t.trial_id)
        else:
            p = t.params
            t.final_metric = -(p.get("lr", 0.5) - 0.4) ** 2 + 0.01 * p.get("budget", 1)
            opt.final_store.append(t)
        opt.report(t)


@pytest.mark.parametrize("fail_every", [0, 4])
def test_hyperband_schedule_matches_jax(fail_every):
    kw = dict(seed=3, pruner="hyperband", pruner_kwargs=dict(min_budget=1, max_budget=9, eta=3))
    ours, ref = RandomSearch(**kw), JaxRandomSearch(**kw)
    for opt, space in ((ours, Searchspace), (ref, JaxSearchspace)):
        opt.searchspace = space(lr=("DOUBLE", [0.0, 1.0]))
        opt.direction = "max"
    assert ours.init_pruner().num_trials() == ref.init_pruner().num_trials() == 22
    got = _run_schedule(ours, ours._initialize, fail_every)
    want = _run_schedule(ref, lambda: ref._initialize(exp_dir=None), fail_every)
    assert got == want
    assert ours.pruner.finished() and ref.pruner.finished()
    assert sorted({p["budget"] for p, _, _ in got}) == [1, 3, 9]
    assert len([o for o in got if o[1] == "promoted"]) == 3 + 1 + 1
    if fail_every:
        assert len(got) > 22  # failed slots re-issued


@pytest.mark.parametrize("kind", ["gridsearch", "singlerun"])
def test_fixed_schedules_match_jax(kind):
    space = dict(units=("DISCRETE", [8, 16, 32]), act=("CATEGORICAL", ["relu", "tanh"]))
    if kind == "gridsearch":
        ours, ref = GridSearch(), JaxGridSearch()
        ours.searchspace, ref.searchspace = Searchspace(**space), JaxSearchspace(**space)
        n = GridSearch.get_num_trials(ours.searchspace)
        assert n == JaxGridSearch.get_num_trials(ref.searchspace) == 6
    else:
        ours, ref, n = SingleRun(), JaxSingleRun(), 5
    for opt in (ours, ref):
        opt.num_trials = n
        opt.direction = "max"
    got = [(p, s) for p, s, _ in _run_schedule(ours, ours._initialize)]
    want = [(p, s) for p, s, _ in _run_schedule(ref, lambda: ref._initialize(exp_dir=None))]
    assert got == want and len(got) == n
    with pytest.raises(ValueError, match="pruner"):
        type(ours)(pruner="hyperband")


def test_gridsearch_driver_sizes_the_schedule(env):
    sp = Searchspace(units=("DISCRETE", [8, 16, 32]), act=("CATEGORICAL", ["relu", "tanh"]))
    result = experiment.lagom(lambda units, act: {"metric": units / 32 + (act == "relu")},
                              _config(name="grid", num_trials=1, optimizer="gridsearch",
                                      searchspace=sp, experiment_dir=tempfile.mkdtemp()))
    assert result["num_trials"] == 6 and result["best_hp"] == {"units": 32, "act": "relu"}
    assert math.isclose(result["best_val"], 2.0)
    result = experiment.lagom(lambda run_index: {"metric": float(run_index)}, _config(
        name="single", num_trials=3, optimizer="none", searchspace=None,
        experiment_dir=tempfile.mkdtemp()))
    assert result["num_trials"] == 3 and result["best_val"] == 2.0
    assert np.isclose(result["avg"], 1.0)


@pytest.mark.timeout(120)
def test_pipeline_stress_many_runners():
    """More runner threads than cores and a short switch interval, through
    ASHA (promotions invalidate prefetched samples): every rung-0 sample
    runs exactly once, every trial finalizes once, and no controller
    suggestion collides in the trial store."""
    import sys

    runners = min(16, (os.cpu_count() or 2) + 2)
    exp_dir = tempfile.mkdtemp()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        result = experiment.lagom(
            lambda lr, budget, reporter: _sleepy_train(lr, reporter),
            _config(name="stress", num_trials=16, optimizer=Asha(2, 1, 4, seed=5),
                    num_workers=runners, hb_interval=0.01, experiment_dir=exp_dir))
    finally:
        sys.setswitchinterval(old)
    trials = []
    for run in os.listdir(exp_dir):
        for entry in os.listdir(os.path.join(exp_dir, run)):
            path = os.path.join(exp_dir, run, entry, "trial.json")
            if os.path.exists(path):
                trials.append(json.load(open(path)))
            log = os.path.join(exp_dir, run, "maggy.log")
            assert not os.path.exists(log) or "WARNING" not in open(log).read()
    ids = [t["id"] for t in trials]
    assert len(ids) == len(set(ids)) == result["num_trials"]
    assert sum(t["info_dict"].get("rung", 0) == 0 for t in trials) == 16
    assert all(t["status"] == "FINALIZED" for t in trials)
    assert max(t["params"]["budget"] for t in trials) == 4
