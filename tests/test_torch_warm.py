"""The port's compile-once warm path on the CPU, against maggy_tpu.

Counterparts of ``tests/test_warm.py``: program keys (a swept family shares
one slot, a plain factory or an unidentifiable module gets a private one),
the warm cache's bounds, the no-state-leak guarantee (warm trials bitwise
equal to cold ones, a hit counted and its unit consumed, ``fresh_state``'s
bit-fresh init), the runner stats' compile record. Against the JAX package:
the same Trainer constructions share slots and count hits and misses alike,
a one-runner sweep journals the same compile block, swept trials train to
the JAX Trainer's losses, and a slot shared across learning rates, or a
restore after steps, trains as cold. On the CPU nothing is captured; the
CUDA-graph half runs in ``chip_smoke.py``.
"""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from maggy_tpu import experiment as jax_experiment
from maggy_tpu.config import OptimizationConfig as JaxConfig
from maggy_tpu.models import MnistCNN as JaxMnistCNN
from maggy_tpu.parallel import make_mesh
from maggy_tpu.searchspace import Searchspace as JaxSearchspace
from maggy_tpu.telemetry import replay_journal as jax_replay_journal
from maggy_tpu.telemetry.runnerstats import RunnerStats as JaxRunnerStats
from maggy_tpu.train import Trainer as JaxTrainer
from maggy_tpu.train import clear_warm as jax_clear_warm
from maggy_tpu.train import cross_entropy_loss as jax_xent
from maggy_tpu.train import swept_transform as jax_swept_transform
from maggy_tpu.train import warm as jax_warm

from maggy_tpu_torch import OptimizationConfig, Searchspace, experiment
from maggy_tpu_torch.models import Llama, LlamaConfig, MnistCNN
from maggy_tpu_torch.models.mnist_cnn import flax_to_state_dict
from maggy_tpu_torch.ops import attention
from maggy_tpu_torch.telemetry import replay_journal
from maggy_tpu_torch.telemetry.runnerstats import RunnerStats
from maggy_tpu_torch.train import (Trainer, adam, adamw, clear_warm, cross_entropy_loss,
                                   only_lora, swept_transform, warm, warm_cache,
                                   warmup_cosine_decay_schedule)

pytestmark = [pytest.mark.torch, pytest.mark.timeout(60)]

RNG = np.random.default_rng(0)
X = RNG.normal(size=(32, 8, 8, 1)).astype(np.float32)
Y = (RNG.normal(size=(32,)) > 0).astype(np.int32)
BATCH = {"inputs": (torch.from_numpy(X),), "labels": torch.from_numpy(Y).long()}
#: tests/test_torch_mnist.py's Trainer tolerance: fp32 on both sides, the
#: sums in another order.
REL, ABS = 1e-5, 1e-6


def loss_fn(logits, batch):
    return cross_entropy_loss(logits, batch["labels"])


def jax_loss_fn(logits, batch):
    return jax_xent(logits, batch["labels"])


def model(device="meta"):
    return MnistCNN(3, 2, features=4, num_classes=2, image_size=8, device=device)


def make_trainer(lr, warm_start=None, step_key=None, factory=None, loss=loss_fn):
    return Trainer(model(), factory or swept_transform(adam, learning_rate=lr), loss,
                   device="cpu", warm_start=warm_start, step_key=step_key)


def run_trial(lr, steps=3, warm_start=None, retire=True, factory=None):
    trainer = make_trainer(lr, warm_start=warm_start, factory=factory).init(seed=0)
    losses = [float(trainer.step(BATCH)) for _ in range(steps)]
    if retire:
        trainer.retire_to_warm_cache()
    return trainer, losses


@pytest.fixture(autouse=True)
def fresh_cache():
    clear_warm()
    jax_clear_warm()
    yield
    clear_warm()
    jax_clear_warm()


def counter_delta(c0):
    now = warm.counters()
    return {k: now[k] - c0[k] for k in c0}


class TestProgramKeys:
    def test_swept_family_shares_one_slot(self):
        t1, t2 = make_trainer(3e-3), make_trainer(1e-4)
        assert t1._slot is t2._slot and t1._slot.key is not None
        assert len(warm_cache()) == 1

    def test_different_optimizer_family_does_not_share(self):
        t1 = make_trainer(1e-3)
        t2 = make_trainer(None, factory=swept_transform(adamw, learning_rate=1e-3))
        assert t1._slot is not t2._slot

    def test_plain_factory_gets_private_slot(self):
        t1 = make_trainer(None, factory=adam(1e-3))
        t2 = make_trainer(None, factory=adam(1e-3))
        assert t1._slot is not t2._slot and t1._slot.key is None
        assert len(warm_cache()) == 0

    def test_manual_step_key_still_shares(self):
        t1 = make_trainer(1e-3, step_key=("k",))
        t2 = make_trainer(5e-3, step_key=("k",), factory=adam(5e-3))
        assert t1._slot is t2._slot

    def test_warm_start_false_takes_no_slot(self):
        t = make_trainer(1e-3, warm_start=False).init(seed=0)
        assert t._slot is None and t._unit is None
        assert len(warm_cache()) == 0

    def test_lambda_loss_misses(self):
        t1 = make_trainer(1e-3, loss=lambda o, b: cross_entropy_loss(o, b["labels"]))
        t2 = make_trainer(1e-3, loss=lambda o, b: cross_entropy_loss(o, b["labels"]))
        assert t1._slot is not t2._slot

    @pytest.mark.parametrize("kind", ["no_identity", "unhashable_identity"])
    def test_unidentifiable_module_is_private(self, kind):
        module = torch.nn.Sequential(torch.nn.Flatten(), torch.nn.Linear(64, 2))
        if kind == "unhashable_identity":
            module.identity = (torch.nn.Sequential, [64, 2])
        t = Trainer(module, swept_transform(adam, learning_rate=1e-3), loss_fn, device="cpu")
        assert t._slot is not None and t._slot.key is None
        assert len(warm_cache()) == 0
        t.init(state_dict=module.state_dict())  # a private slot still trains
        assert np.isfinite(float(t.step(BATCH)))

    def test_schedule_hparam_is_family_less(self):
        def sched():
            return warmup_cosine_decay_schedule(0.0, 1e-3, 2, 10)

        factory = swept_transform(adamw, learning_rate=sched())
        assert warm.opt_family(factory) is None
        t1 = make_trainer(None, factory=factory)
        t2 = make_trainer(None, factory=swept_transform(adamw, learning_rate=sched()))
        assert t1._slot is not t2._slot and len(warm_cache()) == 0

    def test_stringly_static_hparams_still_share(self):
        """Equal statics and baked values keep the family; a baked value
        that differs (AdamW takes weight decay as a float) does not."""
        f1 = warm.opt_family(swept_transform(adamw, learning_rate=1e-3, weight_decay=1e-4))
        f2 = warm.opt_family(swept_transform(adamw, learning_rate=3e-3, weight_decay=1e-4))
        f3 = warm.opt_family(swept_transform(adamw, learning_rate=3e-3, weight_decay=5e-4))
        assert f1 is not None and f1 == f2 and f1 != f3

        def named_adam(learning_rate, mode="plain"):
            return adam(learning_rate)

        g1 = warm.opt_family(swept_transform(named_adam, learning_rate=1e-3, mode="x"))
        g2 = warm.opt_family(swept_transform(named_adam, learning_rate=2e-3, mode="x"))
        assert g1 is not None and g1 == g2

    def test_only_lora_carries_the_inner_family(self):
        inner = swept_transform(adamw, learning_rate=1e-3)
        wrapped = only_lora(inner)
        assert warm.opt_family(wrapped) == ("only_lora", warm.opt_family(inner))
        assert warm.opt_family(only_lora(adamw(1e-3))) is None
        assert wrapped.kwargs == inner.kwargs and wrapped.scheduler is inner.scheduler


class TestWarmCacheBounds:
    def test_lru_bound_and_clear(self):
        cache = warm.WarmCache(maxsize=2)
        a, hit_a = cache.slot("a")
        assert not hit_a
        cache.slot("b")
        cache.slot("c")  # evicts "a"
        assert len(cache) == 2 and "a" not in cache.keys()
        a2, hit_a2 = cache.slot("a")
        assert not hit_a2 and a2 is not a
        cache.clear()
        assert len(cache) == 0

    def test_lru_touch_refreshes(self):
        cache = warm.WarmCache(maxsize=2)
        cache.slot("a")
        cache.slot("b")
        cache.slot("a")  # touch
        cache.slot("c")  # evicts "b", not "a"
        assert set(cache.keys()) == {"a", "c"}

    def test_env_bound(self, monkeypatch):
        monkeypatch.setenv("MAGGY_TPU_WARM_SLOTS", "3")
        assert warm.WarmCache().maxsize == 3

    def test_one_retired_unit_per_runner(self):
        entry = warm._InitEntry()
        entry.store_retired("a1", runner=1)
        entry.store_retired("b", runner=2)
        entry.store_retired("a2", runner=1)  # replaces runner 1's
        assert list(entry.retired.values()) == ["b", "a2"]
        assert entry.take_retired(runner=1) == "a2"  # its own first
        assert entry.take_retired(runner=1) == "b"  # then another's
        assert entry.take_retired(runner=1) is None


class TestNoStateLeak:
    def test_warm_trials_match_cold_bitwise(self):
        warm_losses = [run_trial(lr)[1] for lr in (3e-3, 1e-3, 7e-4)]
        cold_losses = [run_trial(lr, warm_start=False)[1] for lr in (3e-3, 1e-3, 7e-4)]
        assert warm_losses == cold_losses, "stale values leaked through the warm slot"

    def test_warm_hit_counted_and_unit_consumed(self):
        c0 = warm.counters()
        t1, _ = run_trial(3e-3)
        entry = t1._slot.entry
        assert len(entry.retired) == 1
        assert t1.model is None and t1.optimizer is None, "a retired trainer drops its unit"
        t2 = make_trainer(1e-3).init(seed=0)
        assert not entry.retired, "the hit takes the unit"
        unit_model = t2.model
        t2.retire_to_warm_cache()
        assert len(entry.retired) == 1
        t3 = make_trainer(5e-4).init(seed=0)
        assert t3.model is unit_model, "a hit trains the unit's module"
        delta = counter_delta(c0)
        assert delta["warm_hits"] == 2 and delta["warm_misses"] == 1

    def test_fresh_state_scope_inits_bit_fresh_and_retires(self):
        t1, _ = run_trial(3e-3)
        entry = t1._slot.entry
        with warm.trial_scope(trial_id="resumed", enabled=True, fresh_state=True):
            t2 = make_trainer(1e-3).init(seed=0)
            assert not entry.retired  # the unit is this trial's while it runs
            assert t2._slot is t1._slot
            cold = make_trainer(1e-3, warm_start=False).init(seed=0)
            for a, b in zip(t2.model.state_dict().values(), cold.model.state_dict().values()):
                assert torch.equal(a, b)
            assert all(not s or all(float(v.abs().max()) == 0 for v in s.values())
                       for s in t2.optimizer.state.values())
        assert len(entry.retired) == 1  # the resumed trial's unit retired at scope exit

    def test_scope_disabled_forces_legacy(self):
        with warm.trial_scope(trial_id="t", enabled=False):
            t = make_trainer(1e-3)
        assert t._slot is None

    def test_meta_model_materializes_only_on_a_miss(self):
        t1 = make_trainer(1e-3)
        assert next(t1.model.parameters()).is_meta
        t1.init(seed=0)
        assert not next(t1.model.parameters()).is_meta
        t1.retire_to_warm_cache()
        t2 = make_trainer(2e-3)
        built = t2.model
        t2.init(seed=0)
        assert t2.model is not built and next(built.parameters()).is_meta

    def test_reinit_of_a_cast_base_draws_as_a_fresh_build(self):
        """only_lora casts the frozen base to bf16: a warm re-init draws in
        fp32 and casts, bit for bit the fresh build's values."""
        cfg = LlamaConfig.tiny(lora_rank=2)

        def trainer(lr):
            return Trainer(Llama(cfg, device="meta"),
                           only_lora(swept_transform(adamw, learning_rate=lr)),
                           lambda out, b: out.float().mean(), device="cpu")

        t1 = trainer(1e-3).init(seed=3)
        t1.retire_to_warm_cache()
        t2 = trainer(2e-3).init(seed=5)
        fresh = trainer(2e-3).init(seed=5)  # no unit left: a fresh build
        assert t2.model is not fresh.model
        assert any(p.dtype == torch.bfloat16 for p in t2.model.parameters())
        for (name, a), b in zip(t2.model.state_dict().items(),
                                fresh.model.state_dict().values()):
            assert a.dtype == b.dtype and torch.equal(a, b), name


def test_rebind_zeroes_state_and_sets_this_trials_rate():
    factory = swept_transform(adamw, learning_rate=3e-3)
    t = make_trainer(None, factory=factory).init(seed=0)
    for _ in range(2):
        t.step(BATCH)
    assert any(float(v.abs().max()) > 0 for s in t.optimizer.state.values() for v in s.values())
    scheduler = warm.rebind_hyperparams(t.optimizer, swept_transform(adamw, learning_rate=7e-4))
    assert all(float(v.abs().max()) == 0 for s in t.optimizer.state.values() for v in s.values())
    assert scheduler.optimizer is t.optimizer
    assert t.optimizer.param_groups[0]["lr"] == pytest.approx(7e-4)


def test_config_and_executor_carry_warm_start():
    from maggy_tpu_torch.core.executors.trial_executor import trial_executor_fn

    assert OptimizationConfig().warm_start is True
    assert OptimizationConfig(warm_start=False).warm_start is False
    executor = trial_executor_fn(server_addr=("127.0.0.1", 0), secret="s", hb_interval=1.0,
                                 exp_dir="/tmp", optimization_key="metric",
                                 train_fn=lambda: None, warm_start=False)
    assert executor.warm_start is False


def test_graph_replays_add_their_recorded_launches():
    attention.reset_launch_counts()
    attention._launched(attention.flash_fwd)
    attention.add_launches({"flash_fwd": 12, "flash_bwd_dq": 12})
    assert attention.launch_counts() == {"flash_fwd": 13, "flash_bwd_dkdv": 0,
                                         "flash_bwd_dq": 12}
    attention.reset_launch_counts()


def test_a_capture_waits_for_running_steps_and_holds_new_ones_out():
    """The process's step gate: a capture starts only once no step runs,
    and a step that arrives while a capture waits or runs waits for it."""
    import threading
    import time

    from maggy_tpu_torch.device_gate import _Gate

    gate, order = _Gate(), []
    step_in, capture_in = threading.Event(), threading.Event()

    def long_step():
        with gate.step():
            step_in.set()
            time.sleep(0.2)
            order.append("step 1 ends")

    def capture():
        step_in.wait(5)
        with gate.capture():
            capture_in.set()
            order.append("capture")
            time.sleep(0.1)

    def late_step():
        step_in.wait(5)
        time.sleep(0.05)  # arrives while the capture waits
        with gate.step():
            order.append("step 2")

    threads = [threading.Thread(target=f) for f in (long_step, capture, late_step)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10)
    assert order == ["step 1 ends", "capture", "step 2"]


@pytest.mark.parametrize("package", ["port", "jax"])
def test_runner_stats_compile_record(package):
    """The capture's compile_ms and a failed capture's graph_ok land in the
    trial's compile record as the JAX package's compile fields do."""
    stats = (RunnerStats if package == "port" else JaxRunnerStats)()
    stats.trial_start("t1")
    stats.note_compile(warm=False, init_ms=100.0)
    stats.note_compile(compile_ms=200.0)
    stats.note_compile(compile_ms=40.0, graph_ok=False, graph_error="RuntimeError: x")
    stats.note_counter("graph_replays", 3)
    stats.on_broadcast(0)
    stats.trial_end("t1")
    delta = stats.snapshot_delta()
    (record,) = delta["compile_events"]
    assert record["compile_ms"] == 240.0 and record["init_ms"] == 100.0
    assert record["graph_ok"] is False and record["graph_error"] == "RuntimeError: x"
    assert delta["graph_replays"] == 3


# ------------------------------------------------------- against the JAX package


def jax_mesh():
    return make_mesh({"data": 1}, devices=jax.devices()[:1])


JAX_MODEL = JaxMnistCNN(kernel_size=3, pool_size=2, features=4, num_classes=2)
EXAMPLE = (jnp.zeros((1, 8, 8, 1)),)


def jax_trial(tx, steps=2, mesh=None):
    trainer = JaxTrainer(JAX_MODEL, tx, jax_loss_fn, mesh or jax_mesh())
    trainer.init(jax.random.key(0), EXAMPLE)
    state = flax_to_state_dict(jax.tree_util.tree_map(np.asarray,
                                                      trainer.variables["params"]))
    batch = trainer.place_batch({"inputs": (jnp.asarray(X),), "labels": jnp.asarray(Y)})
    losses = [float(trainer.step(batch)) for _ in range(steps)]
    slot = trainer._slot
    trainer.retire_to_warm_cache()
    return slot, losses, state


def port_trial(factory, state, steps=2):
    trainer = Trainer(model(), factory, loss_fn, device="cpu").init(state_dict=state)
    losses = [float(trainer.step(BATCH)) for _ in range(steps)]
    slot = trainer._slot
    trainer.retire_to_warm_cache()
    return slot, losses


def test_five_constructions_share_slots_and_count_as_jax():
    """The same sequence of Trainer constructions (swept lr, another swept
    lr, a plain optimizer, another family, a third swept lr) shares slots
    and counts warm hits and misses alike in both packages, from the same
    converted weights, training to the same losses."""
    mesh = jax_mesh()
    constructions = [
        (jax_swept_transform(optax.adam, learning_rate=3e-3), swept_transform(adam, learning_rate=3e-3)),
        (jax_swept_transform(optax.adam, learning_rate=1e-3), swept_transform(adam, learning_rate=1e-3)),
        (optax.adam(1e-3), adam(1e-3)),
        (jax_swept_transform(optax.adamw, learning_rate=1e-3), swept_transform(adamw, learning_rate=1e-3)),
        (jax_swept_transform(optax.adam, learning_rate=7e-4), swept_transform(adam, learning_rate=7e-4)),
    ]
    seen = {"jax": [], "port": []}
    for tx, factory in constructions:
        j0, p0 = jax_warm.counters(), warm.counters()
        jslot, jlosses, state = jax_trial(tx, mesh=mesh)
        pslot, plosses = port_trial(factory, state)
        seen["jax"].append((jslot if jslot.key is not None else None,
                            jax_warm.counters()["warm_hits"] - j0["warm_hits"],
                            jax_warm.counters()["warm_misses"] - j0["warm_misses"]))
        seen["port"].append((pslot if pslot.key is not None else None,
                             counter_delta(p0)["warm_hits"], counter_delta(p0)["warm_misses"]))
        np.testing.assert_allclose(plosses, jlosses, rtol=REL, atol=ABS)

    def pattern(rows):
        slots = [r[0] for r in rows]
        return [(None if s is None else slots.index(s), h, m) for s, h, m in rows]

    assert pattern(seen["port"]) == pattern(seen["jax"]) == [
        (0, 0, 1), (0, 1, 0), (None, 0, 1), (3, 0, 1), (0, 1, 0)]


def _mnist_trial(lr, reporter):
    trainer = Trainer(model(), swept_transform(adam, learning_rate=lr), loss_fn,
                      device="cpu").init(seed=0)
    for i in range(3):
        loss = trainer.step(BATCH)
        reporter.broadcast(-loss, step=i)
    return {"metric": -float(loss)}


def _jax_mnist_trial(lr, reporter):
    trainer = JaxTrainer(JAX_MODEL, jax_swept_transform(optax.adam, learning_rate=lr),
                         jax_loss_fn, jax_mesh())
    trainer.init(jax.random.key(0), EXAMPLE)
    batch = trainer.place_batch({"inputs": (jnp.asarray(X),), "labels": jnp.asarray(Y)})
    for i in range(3):
        loss = trainer.step(batch)
        reporter.broadcast(-loss, step=i)
    return {"metric": -float(loss)}


@pytest.mark.parametrize("package", ["port", "jax"])
def test_one_runner_sweep_journals_the_compile_block_as_jax(package, tmp_path):
    """bench.py's run_compile_ab shape, cut to 4 trials: a one-runner
    RandomSearch sweep of swept trials journals 3 warm hits and 1 miss,
    read back by each package's replay_journal the same way."""
    kw = dict(name="warm_ab", num_trials=4, optimizer="randomsearch", direction="max",
              num_workers=1, hb_interval=0.05, es_policy="none", seed=11,
              experiment_dir=str(tmp_path))
    space = dict(lr=("DOUBLE_LOG", [1e-4, 3e-2]))
    if package == "port":
        experiment.lagom(_mnist_trial, OptimizationConfig(searchspace=Searchspace(**space), **kw))
    else:
        jax_experiment.lagom(_jax_mnist_trial,
                             JaxConfig(searchspace=JaxSearchspace(**space), **kw))
    (journal,) = glob.glob(os.path.join(str(tmp_path), "*", "telemetry.jsonl"))
    for replay in (replay_journal, jax_replay_journal):
        comp = replay(journal)["compile"]
        assert (comp["warm_hits"], comp["warm_misses"], comp["warm_hit_rate"]) == (3, 1, 0.75)
        assert comp["ttfm_warm"]["n"] == 3 and comp["ttfm_cold"]["n"] == 1


def test_a_shared_slot_across_rates_and_a_restore_train_as_cold():
    """Two trials of one slot with different learning rates, then a third
    that restores the second's saved state after its steps and trains on:
    each trains as a cold trainer doing the same (traps 5 and 6 on the CPU)."""
    def trial(lr, warm_start, restore=None, steps=3):
        trainer = make_trainer(lr, warm_start=warm_start).init(seed=0)
        if restore is not None:
            trainer.model.load_state_dict(restore["model"])
            trainer.optimizer.load_state_dict(restore["optimizer"])
            trainer.scheduler.load_state_dict(restore["scheduler"])
        losses = [float(trainer.step(BATCH)) for _ in range(steps)]
        saved = {"model": {k: v.clone() for k, v in trainer.model.state_dict().items()},
                 "optimizer": trainer.optimizer.state_dict(),
                 "scheduler": trainer.scheduler.state_dict()}
        saved["optimizer"] = {"state": {k: {n: v.clone() for n, v in s.items()}
                                        for k, s in saved["optimizer"]["state"].items()},
                              "param_groups": saved["optimizer"]["param_groups"]}
        trainer.retire_to_warm_cache()
        return losses, saved

    warm_runs, cold_runs = [], []
    for runs, warm_start in ((warm_runs, None), (cold_runs, False)):
        a, _ = trial(3e-3, warm_start)
        b, saved = trial(3e-2, warm_start)
        c, _ = trial(3e-2, warm_start, restore=saved)
        runs.extend([a, b, c])
    assert warm_runs == cold_runs
    assert warm_runs[0] != warm_runs[1] and warm_runs[2][0] != warm_runs[1][0]
