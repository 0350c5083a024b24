"""The port's control plane: whole ASHA, TPE and GP + Hyperband sweeps on
thread runners and one sweep on process runners with JAX, scikit-learn and
the JAX package unimportable (in the runner processes too), the import
boundary by AST, schedule parity of the port's ASHA and RandomSearch with
maggy_tpu's, and a one-runner TPE sweep giving the JAX package's parameter
sequence."""

import ast
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from maggy_tpu import experiment as jax_experiment
from maggy_tpu.config import OptimizationConfig as JaxConfig
from maggy_tpu.optimizers import Asha as JaxAsha
from maggy_tpu.optimizers import RandomSearch as JaxRandomSearch
from maggy_tpu.searchspace import Searchspace as JaxSearchspace
import socket

import torch

from maggy_tpu_torch.core.reporter import Reporter
from maggy_tpu_torch.core.rpc import MessageSocket
from maggy_tpu_torch.exceptions import (AuthenticationError, BroadcastMetricTypeError,
                                        EarlyStopException)
from maggy_tpu_torch import OptimizationConfig, experiment
from maggy_tpu_torch.optimizers import Asha, RandomSearch
from maggy_tpu_torch.searchspace import Searchspace

# Each test bounded (a test that hangs fails alone instead of cutting the
# whole run); the tests that set their own, longer bound keep it.
pytestmark = [pytest.mark.torch, pytest.mark.timeout(60)]

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: The store libraries: the card's machine has neither, so the port may
#: import gcsfs only where a ``GCSEnv`` is built without a filesystem.
STORE_LIBS = ("fsspec", "gcsfs")
BANNED = ("jax", "jaxlib", "flax", "optax", "orbax", "msgpack", "sklearn",
          "maggy_tpu") + STORE_LIBS

_SWEEP = textwrap.dedent("""
    import importlib.abc, importlib.machinery, json, os, sys, tempfile

    BANNED = {banned!r}

    class Refuse(importlib.abc.Loader):
        def create_module(self, spec):
            raise ImportError("blocked import: " + spec.name)

        def exec_module(self, module):
            pass

    class Block(importlib.abc.MetaPathFinder):
        # An origin-less spec whose loader refuses: importing fails, while a
        # find_spec probe (torch._dynamo's for sklearn) sees no module file,
        # as on a machine where the package is not installed.
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BANNED:
                return importlib.machinery.ModuleSpec(name, Refuse())
            return None

    sys.meta_path.insert(0, Block())
    for name in list(sys.modules):
        if name.split(".")[0] in BANNED:
            del sys.modules[name]
    sys.path.insert(0, {root!r})

    import numpy as np
    import torch
    import maggy_tpu_torch.telemetry
    import maggy_tpu_torch.telemetry.health
    import maggy_tpu_torch.telemetry.obs
    import maggy_tpu_torch.telemetry.profiling
    import maggy_tpu_torch.train.warm
    import maggy_tpu_torch.core.config
    import maggy_tpu_torch.fleet.__main__
    import maggy_tpu_torch.fleet.agent
    import maggy_tpu_torch.telemetry.sink
    import maggy_tpu_torch.chaos.driver_soak
    import maggy_tpu_torch.monitor
    import maggy_tpu_torch.native
    import maggy_tpu_torch.parallel
    import maggy_tpu_torch.core.driver.distributed_driver
    import maggy_tpu_torch.tensorboard
    import maggy_tpu_torch.analysis.__main__
    import maggy_tpu_torch.analysis.witness
    import maggy_tpu_torch.models.remat
    from maggy_tpu_torch import runner
    from maggy_tpu_torch.chaos import harness
    from maggy_tpu_torch import OptimizationConfig, Searchspace, experiment
    from maggy_tpu_torch.models import BertConfig, BertEncoder
    from maggy_tpu_torch.optimizers import PBT, Asha
    from maggy_tpu_torch.optimizers.bayes import GP, TPE
    from maggy_tpu_torch.train import (Trainer, adamw, cross_entropy_loss,
                                       warmup_cosine_decay_schedule)
    from maggy_tpu_torch import AblationConfig
    from maggy_tpu_torch.ablation import AblationStudy
    from maggy_tpu_torch.callbacks import BatchEnd
    from maggy_tpu_torch.models.surgery import ablatable_model_generator
    from maggy_tpu_torch.train import DatasetRegistry, adam
    from maggy_tpu_torch.train.tfrecord import write_tfrecord

    cfg = BertConfig.tiny()
    rng = np.random.default_rng(0)
    tokens = rng.integers(2, cfg.vocab_size, (64, 128))
    mask = np.arange(128)[None] < rng.integers(16, 129, 64)[:, None]
    labels = ((tokens > cfg.vocab_size // 2) & mask).sum(1) * 2 > mask.sum(1)

    def banned_imports():
        return sorted(m for m in sys.modules if m.split(".")[0] in BANNED)

    def train(lr, warmup_frac, reporter, budget=1, batch=8, steps_per_budget=3):
        steps = int(budget) * steps_per_budget
        sched = warmup_cosine_decay_schedule(0.0, lr, int(steps * warmup_frac), steps)
        t = Trainer(BertEncoder(cfg, device="cpu"), adamw(sched),
                    lambda lo, b: cross_entropy_loss(lo, b["labels"]),
                    device="cpu").init(seed=0)
        for i in range(steps):
            lo = (i * batch) % (64 - batch)
            loss = t.step(t.place_batch({{"inputs": (tokens[lo:lo + batch], mask[lo:lo + batch]),
                                          "labels": labels[lo:lo + batch]}}))
            reporter.broadcast(-loss, step=i)
        return {{"metric": -float(loss)}}

    def train_in_process(lr, warmup_frac, reporter):
        # Module-level, so a spawned runner unpickles it from __mp_main__,
        # which re-ran the import hook above before importing anything.
        out = train(lr, warmup_frac, reporter, steps_per_budget=2)
        return {{**out, "banned": banned_imports(), "pid": os.getpid()}}

    def train_dist(sharding_env):
        # A rank of a 2-process {{"seq": 2}} world: the plain ring over its
        # gloo group; the rank records what it imported.
        from maggy_tpu_torch.parallel import ring_attention

        x = torch.ones(1, 4, 2, 8) * (1 + sharding_env.process_index)
        out = ring_attention(x, x, x, sharding_env.group("seq"))
        with open(os.path.join(os.environ["MAGGY_TEST_DIST_OUT"],
                               str(sharding_env.process_index)), "w") as f:
            json.dump({{"banned": banned_imports(), "pid": os.getpid()}}, f)
        return {{"metric": float(out.mean())}}

    def train_gang(lr, warmup_frac, gang, reporter, ctx):
        # A rank of a 2-chip "dp" gang of the tiny BERT: a process of its
        # own, unpickled from __mp_main__ (the hook ran first); rank 0's
        # return is the trial's.
        t = Trainer(BertEncoder(cfg, device="cpu"), adamw(lr),
                    lambda lo, b: cross_entropy_loss(lo, b["labels"]), device="cpu",
                    env=ctx.gang.sharding_env(), strategy="dp").init(seed=0)
        for i in range(2):
            loss = t.step(t.place_batch({{"inputs": (tokens[:8], mask[:8]),
                                          "labels": labels[:8]}}))
            reporter.broadcast(-loss, step=i)
        return {{"metric": -float(loss), "banned": banned_imports(), "pid": os.getpid(),
                 "rank": ctx.gang.process_id, "world": ctx.gang.size}}

    def train_pbt(lr, warmup_frac, generation, member, budget, reporter, ctx):
        # A PBT segment: its parent's checkpoint (staged by the fork) read
        # back with torch.load, its own written with torch.save.
        w = torch.zeros(3)
        if ctx.resume_step is not None:
            w = ctx.restore_checkpoint({{"w": w}})["w"]
        w = w + lr
        reporter.broadcast(float(w.sum()), step=0)
        ctx.save_checkpoint(generation, {{"w": w}})
        return {{"metric": float(w.sum()), "resumed_from": ctx.resume_step}}

    def sweep(name, optimizer, num_trials, space, fn=train, **kw):
        exp_dir = tempfile.mkdtemp()
        result = experiment.lagom(fn, OptimizationConfig(
            name=name, num_trials=num_trials, optimizer=optimizer, searchspace=space,
            direction="max", num_workers=2, es_policy="median", es_min=2, hb_interval=0.05,
            seed=0, experiment_dir=exp_dir, **kw))
        trials, outputs = [], []
        for run in os.listdir(exp_dir):
            for entry in os.listdir(os.path.join(exp_dir, run)):
                p = os.path.join(exp_dir, run, entry, "trial.json")
                if os.path.exists(p):
                    trials.append(json.load(open(p)))
                    outputs.append(json.load(open(os.path.join(exp_dir, run, entry,
                                                               ".outputs.json"))))
        return {{"result": result, "trials": trials, "outputs": outputs,
                 "replay": replay_cli(exp_dir)}}

    def ablation_layers():
        return (("first", lambda: torch.nn.LazyLinear(4)), ("mid", lambda: torch.nn.Linear(4, 4)),
                ("last", lambda: torch.nn.Linear(4, 2)))

    def ablation_model(ablated_layers=frozenset()):
        return ablatable_model_generator(ablation_layers(), ablated_layers)

    def train_ablation(dataset_function, model_function, ablated_feature, ablated_layer,
                       reporter):
        # A LOCO trial: the registry's TFRecord minus its feature, the model
        # minus its layer, trained by Trainer.fit with a callback.
        data = dataset_function()
        y = torch.as_tensor(data.pop("y"), dtype=torch.long)
        x = torch.as_tensor(np.stack([data[k] for k in sorted(data)], axis=1))
        batch = {{"inputs": (x,), "y": y}}
        t = Trainer(model_function(), adam(5e-2), lambda lo, b: cross_entropy_loss(lo, b["y"]),
                    device="cpu").init(seed=0, example_inputs=batch["inputs"])
        t.fit([batch] * 40, callbacks=[BatchEnd(reporter)])
        return {{"metric": float(t.model(x).argmax(-1).eq(y).float().mean())}}

    def ablation_study():
        root = tempfile.mkdtemp()
        rows = rng.normal(size=(32, 2)).astype("float32")
        path = os.path.join(root, "toy.tfrecord")
        write_tfrecord(path, ({{"a": float(r[0]), "b": float(r[1]), "y": int(r[0] > 0)}}
                              for r in rows))
        version = DatasetRegistry(root=root).register("toy", path)
        os.environ["MAGGY_TPU_REGISTRY_ROOT"] = root
        study = AblationStudy("toy", version, "y")
        study.features.include("a", "b")
        study.model.set_base_model_generator(ablation_model)
        study.model.layers.include("mid")
        return study

    def replay_cli(exp_dir):
        # python -m maggy_tpu_torch.telemetry replay <run dir>, under the hook.
        import contextlib, io, runpy
        (run,) = os.listdir(exp_dir)
        buf, argv = io.StringIO(), sys.argv
        sys.argv = ["maggy_tpu_torch.telemetry", "replay", os.path.join(exp_dir, run)]
        try:
            with contextlib.redirect_stdout(buf):
                runpy.run_module("maggy_tpu_torch.telemetry", run_name="__main__")
        except SystemExit as e:
            assert not e.code, e.code
        finally:
            sys.argv = argv
        return json.loads(buf.getvalue())

    def agent_train(lr, warmup_frac, reporter):
        # A remote agent's trial: the agent process runs this script as
        # __main__, whose hook refused the banned modules first.
        reporter.broadcast(1.0 - lr, step=0)
        return {{"metric": 1.0 - lr, "banned": banned_imports(), "pid": os.getpid()}}

    def remote_sweep():
        # pool="remote" served by one `maggy_tpu_torch.runner` agent process
        # started from this script, so the hook runs in the agent too.
        import subprocess, threading
        exp_dir = tempfile.mkdtemp()
        os.environ["MAGGY_TPU_APP_ID"] = "blocked_remote"
        out = {{}}
        config = OptimizationConfig(name="blocked_remote", num_trials=3, searchspace=sp,
                                    num_workers=1, pool="remote", es_policy="none",
                                    hb_interval=0.05, seed=0, experiment_dir=exp_dir)
        thread = threading.Thread(target=lambda: out.setdefault(
            "result", experiment.lagom(None, config)))
        thread.start()
        ticket = os.path.join(exp_dir, "blocked_remote_0", "runner_ticket.json")
        agent = subprocess.run([sys.executable, os.path.abspath(__file__), "--agent", ticket],
                               stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                               timeout=120)
        thread.join(60)
        assert agent.returncode == 0, agent.stderr[-2000:]
        outputs = [json.load(open(os.path.join(exp_dir, "blocked_remote_0", e, ".outputs.json")))
                   for e in os.listdir(os.path.join(exp_dir, "blocked_remote_0"))
                   if os.path.exists(os.path.join(exp_dir, "blocked_remote_0", e,
                                                  ".outputs.json"))]
        return {{"num_trials": out["result"]["num_trials"], "outputs": outputs}}

    if sys.argv[1:2] == ["--agent"]:
        sys.exit(runner.main(["--ticket", sys.argv[2], "--train", "__main__:agent_train"]))

    sp = Searchspace(lr=("DOUBLE_LOG", [1e-5, 1e-3]), warmup_frac=("DOUBLE", [0.0, 0.3]))

    if __name__ == "__main__":
        sp = Searchspace(lr=("DOUBLE_LOG", [1e-5, 1e-3]), warmup_frac=("DOUBLE", [0.0, 0.3]))
        bo_sp = Searchspace(lr=("DOUBLE", [1e-5, 1e-3]), warmup_frac=("DOUBLE", [0.0, 0.3]),
                            batch=("DISCRETE", [4, 8]))
        out = {{"asha": sweep("blocked_imports", Asha(2, 1, 4, seed=0), 6, sp),
                "tpe": sweep("blocked_tpe", TPE(num_warmup_trials=3, seed=0), 14, bo_sp,
                             lambda reporter, **p: train(reporter=reporter, steps_per_budget=2,
                                                         **p)),
                "gp": sweep("blocked_gp", GP(num_warmup_trials=3, seed=0, pruner="hyperband",
                                             pruner_kwargs=dict(min_budget=1, max_budget=9,
                                                                eta=3, n_iterations=1)),
                            1, bo_sp,
                            lambda reporter, **p: train(reporter=reporter, steps_per_budget=1,
                                                        **p)),
                "process": sweep("blocked_process", "randomsearch", 3, sp, train_in_process,
                                 pool="process"),
                "pbt": sweep("blocked_pbt", PBT(population=3, generations=2, seed=0), 6, sp,
                             train_pbt)}}
        # The chaos stall soak with the obs plane on: the health engine,
        # the obs server, a torch.profiler capture and the checker, under
        # the hook.
        stall = harness.run_soak(plan=harness.stall_plan(7), seed=7, hb_loss_timeout=10.0,
                                 base_dir=tempfile.mkdtemp(), obs=True,
                                 config_overrides={{"health_hang_factor": 10.0,
                                                   "health_interval_s": 0.1}})
        out["chaos"] = {{"violations": stall["violations"], "profiles": stall["profiles"]}}
        ablated = experiment.lagom(train_ablation, AblationConfig(
            name="blocked_ablation", ablation_study=ablation_study(), num_workers=2,
            hb_interval=0.05, experiment_dir=tempfile.mkdtemp()))
        out["ablation"] = {{k: ablated[k] for k in ("num_trials", "worst_hp")}}
        # The fleet soak (shared listener, scheduler, preemption, native
        # codec) and a remote agent, under the hook.
        from maggy_tpu_torch.fleet.soak import run_fleet_soak
        fleet = run_fleet_soak(seed=7, base_dir=tempfile.mkdtemp())
        out["fleet"] = {{"ok": fleet["ok"], "violations": fleet["violations"],
                         "preemptions": fleet["replay"]["preemptions"],
                         "native": maggy_tpu_torch.native.is_native()}}
        # The journal sink killed and restarted under two sink-shipping
        # tenants (invariant 12), under the hook.
        from maggy_tpu_torch.fleet.soak import run_sink_soak
        shipped = run_sink_soak(tenants=2, trials=3, base_dir=tempfile.mkdtemp())
        out["sink"] = {{"ok": shipped["ok"], "violations": shipped["violations"]}}
        out["remote"] = remote_sweep()
        os.environ["MAGGY_TEST_DIST_OUT"] = tempfile.mkdtemp()
        from maggy_tpu_torch import DistributedConfig
        dist_result = experiment.lagom(train_dist, DistributedConfig(
            name="dist", num_workers=2, mesh_shape={{"seq": 2}}, strategy="sp",
            backend="process", device="cpu", hb_interval=0.1))
        out["dist"] = {{"result": dist_result, "ranks": [json.load(open(os.path.join(
            os.environ["MAGGY_TEST_DIST_OUT"], str(r)))) for r in (0, 1)]}}
        # A 2-chip gang of the tiny BERT: the ranks are processes of this
        # script, on the CPU.
        os.environ["MAGGY_TPU_TORCH_DEVICE"] = "cpu"
        from maggy_tpu_torch import GangSpec
        out["gang"] = sweep("blocked_gang", "randomsearch", 1, Searchspace(
            lr=("DOUBLE_LOG", [1e-5, 1e-3]), warmup_frac=("DOUBLE", [0.0, 0.3]),
            gang=("GANG", [GangSpec(2)])), train_gang)
        # Two LoRA lanes of a tiny Llama (remat, the chunked loss, the
        # frozen base held once) under the hook.
        import dataclasses
        from maggy_tpu_torch.models import Llama, LlamaConfig
        from maggy_tpu_torch.ops import chunked_next_token_loss
        from maggy_tpu_torch.train import VmapTrainer, only_lora
        lcfg = dataclasses.replace(LlamaConfig.tiny(lora_rank=4), dtype=torch.float32,
                                   remat=True)
        toks = torch.as_tensor(rng.integers(0, lcfg.vocab_size, (2, 32)))
        vt = VmapTrainer(Llama(lcfg, device="meta"),
                         lambda learning_rate: only_lora(adamw(learning_rate)),
                         [{{"learning_rate": 1e-3}}, {{"learning_rate": 3e-2}}],
                         lambda o, b: chunked_next_token_loss(o[0], o[1], b["tokens"]),
                         device="cpu", train_kwargs={{"return_hidden": True}}).init(seed=0)
        out["lora_lanes"] = {{"losses": [vt.step({{"inputs": (toks,), "tokens": toks}}).tolist()
                                         for _ in range(3)],
                              "frozen": len(vt._unit.frozen)}}
        # An object-store environment over an injected filesystem needs
        # neither store library; one without a filesystem refuses to start.
        from maggy_tpu_torch.core.environment import GCSEnv
        gcs = GCSEnv("gs://bucket/base", fs=object())
        try:
            GCSEnv("gs://bucket/base")
            refused = None
        except ImportError as e:
            refused = str(e)
        out["gcs"] = {{"fast_local_writes": gcs.FAST_LOCAL_WRITES, "refused": refused}}
        out["leaked"] = banned_imports()
        out["pid"] = os.getpid()
        print(json.dumps(out))
""")


@pytest.mark.timeout(300)
def test_sweep_runs_with_jax_and_maggy_tpu_blocked(tmp_path):
    # Run from a file, not with -c: a spawned runner re-imports the main
    # module by path (as __mp_main__), which re-installs the import hook.
    script = tmp_path / "blocked_sweeps.py"
    script.write_text(_SWEEP.format(banned=BANNED, root=ROOT))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, str(script)], stdout=subprocess.PIPE,
                          stderr=subprocess.PIPE, text=True, timeout=280, env=env)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["leaked"] == []
    lanes = np.asarray(out["lora_lanes"]["losses"])
    assert lanes.shape == (3, 2) and np.isfinite(lanes).all() and lanes[-1, 0] != lanes[-1, 1]
    assert out["lora_lanes"]["frozen"] > 0
    assert out["gcs"]["fast_local_writes"] is False and "gcsfs" in out["gcs"]["refused"]
    # A LOCO study over a registered TFRecord: 1 + 2 features + 1 layer.
    assert out["ablation"]["num_trials"] == 4
    assert out["ablation"]["worst_hp"]["ablated_feature"] == "a"
    assert out["chaos"]["violations"] == [] and out["chaos"]["profiles"]["auto"] == 1
    assert out["fleet"]["ok"], out["fleet"]["violations"]
    assert out["fleet"]["preemptions"] >= 1 and out["fleet"]["native"]
    assert out["sink"]["ok"], out["sink"]["violations"]
    # The remote agent's trials ran in its own process, which saw none of
    # the banned modules either.
    remote = out["remote"]
    assert remote["num_trials"] == len(remote["outputs"]) == 3
    assert all(o["banned"] == [] for o in remote["outputs"])
    assert {o["pid"] for o in remote["outputs"]} - {out["pid"]} == \
        {o["pid"] for o in remote["outputs"]}
    # The distributed run's two ranks were processes of their own, which
    # saw none of the banned modules either; the causal ring on constant
    # shards averages V (1 on rank 0's shard, 2 on rank 1's) over the keys
    # each rank sees.
    dist = out["dist"]
    assert dist["result"]["num_workers"] == 2
    low, high = sorted(dist["result"]["per_worker"])
    assert low == 1.0 and 1.0 < high < 2.0
    assert all(r["banned"] == [] for r in dist["ranks"])
    assert out["pid"] not in {r["pid"] for r in dist["ranks"]}
    # The gang's rank 0 was a process of its own in a world of two, which
    # saw none of the banned modules either.
    (gang_out,) = out["gang"]["outputs"]
    assert out["gang"]["result"]["num_trials"] == 1 and np.isfinite(gang_out["metric"])
    assert gang_out["banned"] == [] and gang_out["pid"] != out["pid"]
    assert (gang_out["rank"], gang_out["world"]) == (0, 2)
    # The process sweep: every trial ran in a runner process of its own
    # (not the driver's), which saw none of the banned modules either.
    result, outputs = out["process"]["result"], out["process"]["outputs"]
    assert result["num_trials"] == len(outputs) == 3 and result["lost_runners"] == 0
    assert all(o["banned"] == [] for o in outputs)
    assert out["pid"] not in {o["pid"] for o in outputs}
    # The PBT sweep forked every generation-1 segment from its parent's
    # checkpoint, through torch.save, the context and the fork path.
    result, trials, outputs = (out["pbt"][k] for k in ("result", "trials", "outputs"))
    assert result["num_trials"] == len(trials) == 6
    assert sorted(o["resumed_from"] for o in outputs if o["resumed_from"] is not None) == [0] * 3
    assert out["pbt"]["replay"]["fork"]["forked"] == 3
    # Every sweep's journal, replayed by the telemetry CLI under the hook.
    for name in ("asha", "tpe", "gp", "process", "pbt"):
        replay = out[name]["replay"]
        assert replay["torn_lines"] == 0, name
        assert replay["trials"]["finalized"] == len(out[name]["trials"]), name
    result, trials = out["asha"]["result"], out["asha"]["trials"]
    assert set(result) >= {"best_id", "best_val", "best_hp", "worst_val", "avg",
                           "num_trials", "early_stopped", "pipeline"}
    assert set(result["best_hp"]) == {"lr", "warmup_frac"}
    assert np.isfinite(result["best_val"])
    # 6 rung-0 samples, then promotions up the rf=2 ladder (budgets 1, 2, 4).
    rung0 = [t for t in trials if t["info_dict"].get("rung", 0) == 0]
    promoted = [t for t in trials if t["info_dict"].get("sample_type") == "promoted"]
    assert len(rung0) == 6 and len(promoted) >= 2
    assert max(t["params"]["budget"] for t in trials) == 4
    assert result["num_trials"] == len(trials)
    assert all(t["status"] == "FINALIZED" for t in trials)
    assert result["early_stopped"] == sum(t["early_stop"] for t in trials)
    # TPE over the BERT example's space: every trial finalized, and the KDEs
    # proposed once 2(d+1) = 8 trials had finalized.
    result, trials = out["tpe"]["result"], out["tpe"]["trials"]
    assert result["num_trials"] == len(trials) == 14
    assert set(result["best_hp"]) == {"lr", "warmup_frac", "batch"}
    assert any(t["info_dict"]["sample_type"] == "model" for t in trials)
    assert result["pipeline"]["prefetch_hits"] > 0
    assert "rpc-server" not in result["pipeline"]["suggest_threads"]
    # GP + Hyperband(1, 9, 3, one bracket): 9 + 3 + 1 trials at budgets 1, 3, 9.
    result, trials = out["gp"]["result"], out["gp"]["trials"]
    budgets = sorted(t["params"]["budget"] for t in trials)
    assert result["num_trials"] == len(trials) == 13
    assert budgets == [1] * 9 + [3] * 3 + [9]
    assert sum(t["info_dict"]["sample_type"] == "promoted" for t in trials) == 4
    assert "rpc-server" not in result["pipeline"]["suggest_threads"]


def _imported_roots(path, top_level=False):
    """The top-level package of every import in ``path`` (with
    ``top_level``, of the module-level statements only)."""
    tree = ast.parse(open(path).read(), filename=path)
    for node in (tree.body if top_level else ast.walk(tree)):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_port_imports_nothing_of_jax_or_maggy_tpu():
    files = [os.path.join(ROOT, "chip_smoke.py"), os.path.join(ROOT, "fork_hold_probe.py")]
    for dirpath, _, names in os.walk(os.path.join(ROOT, "maggy_tpu_torch")):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    scanned = {os.path.relpath(f, ROOT) for f in files}
    assert {os.path.join("maggy_tpu_torch", "telemetry", n + ".py")
            for n in ("__init__", "__main__", "vocab", "metrics", "journal", "spans",
                      "goodput", "runnerstats", "trace")} <= scanned
    assert {os.path.join("maggy_tpu_torch", *p) for p in (
        ("train", "warm.py"), ("train", "checkpoint.py"), ("core", "executors", "context.py"),
        ("optimizers", "pbt.py"), ("core", "driver", "recovery.py"), ("train", "trainer.py"),
        ("train", "optim.py"), ("train", "lora.py"), ("models", "params.py"),
        ("train", "tfrecord.py"), ("train", "registry.py"), ("train", "data.py"),
        ("ablation", "ablationstudy.py"), ("ablation", "ablator", "abstractablator.py"),
        ("ablation", "ablator", "loco.py"), ("models", "surgery.py"), ("callbacks.py",),
        ("core", "driver", "ablation_driver.py"), ("train", "vmap.py"),
        ("core", "config.py"), ("native", "__init__.py"), ("runner.py",), ("monitor.py",),
        ("fleet", "__init__.py"), ("fleet", "__main__.py"), ("fleet", "scheduler.py"),
        ("fleet", "soak.py"), ("core", "rpc.py"), ("core", "runner_pool.py"),
        ("fleet", "agent.py"), ("telemetry", "sink.py"), ("chaos", "driver_soak.py"),
        ("parallel", "__init__.py"), ("parallel", "mesh.py"), ("parallel", "sharding.py"),
        ("parallel", "ring_attention.py"), ("parallel", "ulysses.py"),
        ("parallel", "collectives.py"), ("parallel", "gloo_cuda_probe.py"),
        ("core", "executors", "dist_executor.py"),
        ("core", "driver", "distributed_driver.py"), ("gang.py",),
        ("parallel", "sharded.py"), ("parallel", "pipeline.py"), ("tensorboard.py",),
        ("analysis", "__init__.py"), ("analysis", "__main__.py"), ("analysis", "astindex.py"),
        ("analysis", "guards.py"), ("analysis", "lockorder.py"), ("analysis", "rpcconf.py"),
        ("analysis", "journalvocab.py"), ("analysis", "witness.py"),
        ("core", "environment", "abstractenvironment.py"),
        ("core", "environment", "singleton.py"), ("telemetry", "profiling.py"),
        ("models", "remat.py"), ("ops", "losses.py"))} <= scanned
    assert {os.path.join("maggy_tpu_torch", "examples", n + ".py") for n in (
        "__init__", "mnist_hpo", "bert_glue_hpo", "llama_lora_sweep", "resnet_cifar_asha",
        "vit_cifar_hpo", "pbt_sweep", "titanic_ablation", "distributed_training")} <= scanned
    offenders = {os.path.relpath(f, ROOT): sorted(set(_imported_roots(f)) & set(BANNED))
                 for f in files}
    # gcsfs only inside GCSEnv.__init__, where no filesystem was given.
    lazy = os.path.join("maggy_tpu_torch", "core", "environment", "abstractenvironment.py")
    assert offenders.pop(lazy) == ["gcsfs"]
    assert "gcsfs" not in set(_imported_roots(os.path.join(ROOT, lazy), top_level=True))
    assert {f: r for f, r in offenders.items() if r} == {}
    # The event-file writer and the analyzer need neither tensorboard nor
    # protobuf (the card's machine has neither); the analyzer, pure AST,
    # not torch either.
    for f in files:
        rel = os.path.relpath(f, ROOT)
        roots = set(_imported_roots(f))
        if rel == os.path.join("maggy_tpu_torch", "tensorboard.py"):
            assert not roots & {"tensorboard", "google"}, rel
        elif rel.startswith(os.path.join("maggy_tpu_torch", "analysis")):
            assert not roots & {"tensorboard", "google", "torch", "numpy"}, rel


def _simulate(opt, initialize, num_trials, workers=2):
    """Drive an optimizer like the driver does, deterministically: up to
    ``workers`` trials in flight, the oldest finalizing first with a
    closed-form metric. Returns the suggested params in order."""
    opt.num_trials = num_trials
    opt.direction = "max"
    initialize()
    order, in_flight, last = [], [], None
    while True:
        while len(in_flight) < workers:
            suggestion = opt.get_suggestion(last)
            last = None
            if suggestion in (None, "IDLE"):
                break
            opt.trial_store[suggestion.trial_id] = suggestion
            in_flight.append(suggestion)
            order.append(dict(suggestion.params))
        if not in_flight:
            return order
        trial = in_flight.pop(0)
        p = trial.params
        trial.final_metric = -(np.log10(p["lr"]) + 3.5) ** 2 - p["warmup_frac"] \
            + 0.05 * p.get("budget", 1)
        opt.trial_store.pop(trial.trial_id)
        opt.final_store.append(trial)
        last = trial


SPACE = dict(lr=("DOUBLE_LOG", [1e-5, 1e-3]), warmup_frac=("DOUBLE", [0.0, 0.3]))


@pytest.mark.parametrize("kind", ["asha", "randomsearch"])
def test_schedule_parity_with_maggy_tpu(kind):
    if kind == "asha":
        ours, ref = Asha(3, 1, 9, seed=0), JaxAsha(3, 1, 9, seed=0)
        n = 9
    else:
        ours, ref = RandomSearch(seed=7), JaxRandomSearch(seed=7)
        n = 8
    ours.searchspace = Searchspace(**SPACE)
    ref.searchspace = JaxSearchspace(**SPACE)
    ours_order = _simulate(ours, ours.initialize, n)
    ref_order = _simulate(ref, ref._initialize, n)
    assert ours_order == ref_order
    if kind == "asha":
        assert len(ours_order) == 13  # 9 + 3 promoted to rung 1 + 1 to rung 2
        assert max(p["budget"] for p in ours_order) == 9


def _closed_form(lr, warmup_frac, batch, reporter):
    reporter.broadcast(lr, step=0)
    return {"metric": -(np.log10(lr) + 3.5) ** 2 - warmup_frac + 0.01 * (batch == 64)}


def _param_sequence(exp_dir):
    trials = []
    for run in os.listdir(exp_dir):
        for entry in os.listdir(os.path.join(exp_dir, run)):
            path = os.path.join(exp_dir, run, entry, "trial.json")
            if os.path.exists(path):
                trials.append(json.load(open(path)))
    trials.sort(key=lambda t: t["info_dict"]["sampling_time"])
    return [(t["params"], t["info_dict"]["sample_type"]) for t in trials]


@pytest.mark.timeout(120)
def test_one_runner_tpe_sweep_gives_maggy_tpus_parameter_sequence(tmp_path):
    """The whole sweep through both packages' lagom, one runner, the same
    seed: the same parameters in the same order. With prefetch off, each
    suggestion sees every earlier trial finalized in both packages; with it
    on, how many a prefetched suggestion sees depends on thread timing."""
    from maggy_tpu.optimizers.bayes import TPE as JaxTPE
    from maggy_tpu_torch.optimizers.bayes import TPE

    space = dict(lr=("DOUBLE", [1e-5, 1e-3]), warmup_frac=("DOUBLE", [0.0, 0.3]),
                 batch=("DISCRETE", [32, 64]))
    kw = dict(name="tpe_parity", num_trials=14, direction="max", num_workers=1,
              es_policy="none", hb_interval=0.05, seed=0, prefetch=False)
    experiment.lagom(_closed_form, OptimizationConfig(
        optimizer=TPE(num_warmup_trials=4, seed=0), searchspace=Searchspace(**space),
        experiment_dir=str(tmp_path / "port"), **kw))
    jax_experiment.lagom(_closed_form, JaxConfig(
        optimizer=JaxTPE(num_warmup_trials=4, seed=0), searchspace=JaxSearchspace(**space),
        experiment_dir=str(tmp_path / "jax"), **kw))
    ours, ref = _param_sequence(str(tmp_path / "port")), _param_sequence(str(tmp_path / "jax"))
    assert len(ours) == 14 and sum(s == "model" for _, s in ours) >= 2
    assert ours == ref


def test_reporter_keeps_tensor_metrics_lazy_and_stops_on_flag():
    rep = Reporter()
    rep.reset(trial_id="t1")
    loss = torch.tensor(0.25)
    rep.broadcast(loss, step=0)
    assert rep.metric is loss  # stored as given: no host sync in the training thread
    assert rep.get_data()["metric"] == 0.25
    with pytest.raises(BroadcastMetricTypeError):
        rep.broadcast(torch.tensor(True), step=1)
    with pytest.raises(BroadcastMetricTypeError):
        rep.broadcast(torch.ones(2), step=1)
    rep.early_stop(trial_id="other")  # a STOP about another trial is ignored
    rep.broadcast(torch.tensor(0.5), step=1)
    rep.early_stop(trial_id="t1")
    with pytest.raises(EarlyStopException) as e:
        rep.broadcast(torch.tensor(0.75), step=2)
    assert e.value.metric == 0.75


def test_frames_carry_json_and_reject_a_bad_hmac():
    a, b = socket.socketpair()
    try:
        MessageSocket.send_msg(a, {"type": "METRIC", "value": np.float32(1.5)}, b"k1")
        assert MessageSocket.recv_msg(b, b"k1") == {"type": "METRIC", "value": 1.5}
        MessageSocket.send_msg(a, {"type": "GET"}, b"k1")
        with pytest.raises(AuthenticationError):
            MessageSocket.recv_msg(b, b"k2")
    finally:
        a.close()
        b.close()
