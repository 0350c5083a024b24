"""The port's object-store environment against the JAX package's.

``GCSEnv`` runs the JAX contract cases of ``tests/test_gcs_env.py`` (the
scheme, ``mkdir``, dump/load/exists, bare and missing ``ls``, delete, an
``open_file`` round trip, the experiment registry, ``build_summary`` and
``DatasetRegistry`` on a ``gs://`` root): the JAX ``GCSEnv`` on fsspec's
``MemoryFileSystem`` and the port's, on the same filesystem and on
``chip_smoke.py``'s ``SmokeStore`` (the card's stand-in store), give the
same results. Then ``exclusive_create`` (one winner of eight threads on
the stand-in, whose ``if_generation_match=0`` is exclusive; the
``TypeError`` and 412 paths on stub filesystems, through both packages),
``EnvSing``'s ``gs://`` choice and the refusal without gcsfs, the driver's
inline FINAL path (``_inline_final_enabled``) for both environments, the
checkpointer and fork staging on a ``gs://`` trial dir against a local one
(the same steps and tensors, nothing written locally), the JAX
checkpointer's fault on such a dir (ROADMAP queue 3 item 28), the port's
object-store resume through ``lagom`` (the JAX test's numbers; the JAX
sweep itself is not run here, it hangs under load, queue 3 item 5), and a
sweep's TensorBoard event files in a store against a local run's.
"""

import io
import json
import os
import sys
import threading
import types

import numpy as np
import pytest
import torch

fsspec_memory = pytest.importorskip("fsspec.implementations.memory")

import chip_smoke  # noqa: E402
from maggy_tpu import util as jax_util  # noqa: E402
from maggy_tpu.config import OptimizationConfig as JaxConfig  # noqa: E402
from maggy_tpu.core.driver.optimization_driver import \
    OptimizationDriver as JaxDriver  # noqa: E402
from maggy_tpu.core.environment import EnvSing as JaxEnvSing  # noqa: E402
from maggy_tpu.core.environment.abstractenvironment import GCSEnv as JaxGCSEnv  # noqa: E402
from maggy_tpu.core.environment.abstractenvironment import \
    LocalEnv as JaxLocalEnv  # noqa: E402
from maggy_tpu.searchspace import Searchspace as JaxSearchspace  # noqa: E402
from maggy_tpu.train.registry import DatasetRegistry as JaxRegistry  # noqa: E402
from maggy_tpu_torch import OptimizationConfig, Searchspace, experiment, util  # noqa: E402
from maggy_tpu_torch import tensorboard  # noqa: E402
from maggy_tpu_torch.core.driver.optimization_driver import OptimizationDriver  # noqa: E402
from maggy_tpu_torch.core.environment import (AbstractEnv, EnvSing, GCSEnv,  # noqa: E402
                                              LocalEnv)
from maggy_tpu_torch.telemetry import read_events  # noqa: E402
from maggy_tpu_torch.train import checkpoint as ckpt  # noqa: E402
from maggy_tpu_torch.train.registry import DatasetRegistry  # noqa: E402
from maggy_tpu_torch.train.tfrecord import iter_tfrecord  # noqa: E402

from tests.test_resume import train_counting  # noqa: E402

MemoryFileSystem = fsspec_memory.MemoryFileSystem

pytestmark = [pytest.mark.torch, pytest.mark.timeout(120)]

BASE = "gs://bucket/maggy-exp"

#: (GCSEnv, util, DatasetRegistry) of each package.
PACKAGES = {"jax": (JaxGCSEnv, jax_util, JaxRegistry), "port": (GCSEnv, util, DatasetRegistry)}


def memory_fs():
    """fsspec's in-memory filesystem, emptied (its storage is process-wide)."""
    fs = MemoryFileSystem()
    fs.store.clear()
    fs.pseudo_dirs.clear()
    fs.pseudo_dirs.append("")
    return fs


def make_fs(backend, tmp_path):
    return memory_fs() if backend == "memory" else chip_smoke.SmokeStore(
        str(tmp_path / "store"))


@pytest.fixture(autouse=True)
def reset_env_singletons():
    EnvSing.reset()
    JaxEnvSing.reset()
    yield
    EnvSing.reset()
    JaxEnvSing.reset()


# ------------------------------------------------------ the JAX contract


def case_scheme(env_cls, env, _util, _registry, tmp):
    with pytest.raises(ValueError) as err:
        env_cls("/local/path", fs=env.fs)
    return str(err.value)


def case_mkdir(env_cls, env, _util, _registry, tmp):
    path = BASE + "/exp_0"
    before = env.isdir(path)
    env.mkdir(path)
    return [before, env.isdir(path), env.ls(path)]


def case_dump_load_exists(env_cls, env, _util, _registry, tmp):
    path = BASE + "/exp_0/trial.json"
    before = env.exists(path)
    env.dump('{"a": 1}', path)
    return [before, env.exists(path), json.loads(env.load(path))]


def case_ls_bare_names(env_cls, env, _util, _registry, tmp):
    env.dump("x", BASE + "/exp_0/t1/trial.json")
    env.dump("x", BASE + "/exp_0/t2/trial.json")
    env.dump("y", BASE + "/exp_0/result.json")
    return env.ls(BASE + "/exp_0")


def case_ls_missing(env_cls, env, _util, _registry, tmp):
    return env.ls(BASE + "/nope")


def case_delete(env_cls, env, _util, _registry, tmp):
    env.dump("x", BASE + "/exp_0/a.json")
    env.delete(BASE + "/exp_0/a.json")
    gone = not env.exists(BASE + "/exp_0/a.json")
    env.delete(BASE + "/exp_0/a.json")  # idempotent, as on a disk
    env.dump("x", BASE + "/exp_1/t/f.json")
    env.delete(BASE + "/exp_1", recursive=True)
    return [gone, env.exists(BASE + "/exp_1/t/f.json")]


def case_open_file(env_cls, env, _util, _registry, tmp):
    with env.open_file(BASE + "/exp_0/log.txt", "w") as f:
        f.write("line\n")
    with env.open_file(BASE + "/exp_0/log.txt") as f:
        return env_cls.str_or_byte(f.read())


def case_register_update_finalize(env_cls, env, _util, _registry, tmp):
    exp_dir = env.register_experiment("app", 3, {"name": "n"})
    first = json.loads(env.load(exp_dir + "/experiment.json"))
    env.update_experiment(exp_dir, {"extra": 1})
    env.finalize_experiment(exp_dir, "FINISHED", {"result": {"best": 2}})
    return [exp_dir, first, json.loads(env.load(exp_dir + "/experiment.json"))]


def case_build_summary(env_cls, env, util_mod, _registry, tmp):
    exp_dir = env.register_experiment("app", 0, {})
    for tid, metric in [("t1", 0.5), ("t2", 0.9)]:
        env.dump(json.dumps({"lr": 0.1}), "{}/{}/.hparams.json".format(exp_dir, tid))
        env.dump(json.dumps({"metric": metric}), "{}/{}/.outputs.json".format(exp_dir, tid))
    summary = util_mod.build_summary(exp_dir, env=env)
    summary.pop("built_at")
    return [sorted(summary["combinations"], key=lambda c: c["id"]),
            env.exists(exp_dir + "/.summary.json")]


def case_dataset_registry(env_cls, env, _util, registry_cls, tmp):
    path = os.path.join(tmp, "d.npz")
    if not os.path.exists(path):
        np.savez(path, x=np.arange(6, dtype=np.float32))
    reg = registry_cls(env=env)
    version = reg.register("toy", path, description="bucketed manifest")
    manifest = dict(reg.get("toy"))
    manifest.pop("created")
    return [version, reg.root, manifest, reg.names(), reg.versions("toy")]


CONTRACT = [case_scheme, case_mkdir, case_dump_load_exists, case_ls_bare_names,
            case_ls_missing, case_delete, case_open_file, case_register_update_finalize,
            case_build_summary, case_dataset_registry]


@pytest.mark.parametrize("backend", ["memory", "smoke_store"])
@pytest.mark.parametrize("case", CONTRACT, ids=lambda c: c.__name__[len("case_"):])
def test_contract_matches_jax(case, backend, tmp_path):
    env_cls, util_mod, registry_cls = PACKAGES["jax"]
    want = case(env_cls, env_cls(BASE, fs=memory_fs()), util_mod, registry_cls, str(tmp_path))
    env_cls, util_mod, registry_cls = PACKAGES["port"]
    got = case(env_cls, env_cls(BASE, fs=make_fs(backend, tmp_path)), util_mod, registry_cls,
               str(tmp_path))
    assert got == want


def test_the_interface_and_its_defaults():
    assert issubclass(GCSEnv, LocalEnv) and issubclass(LocalEnv, AbstractEnv)
    assert (AbstractEnv.FAST_LOCAL_WRITES, LocalEnv.FAST_LOCAL_WRITES,
            GCSEnv.FAST_LOCAL_WRITES) == (False, True, False)
    assert GCSEnv(BASE, fs=memory_fs()).sweep_tmp_files(BASE) == 0

    class Dict(AbstractEnv):
        """The default exclusive_create over exists + dump."""

        def __init__(self):
            self.files = {}

        def exists(self, path):
            return path in self.files

        def dump(self, data, path):
            self.files[path] = data

    env = Dict()
    assert env.exclusive_create("a", "p") and not env.exclusive_create("b", "p")
    assert env.files == {"p": "a"} and env.sweep_tmp_files("p") == 0
    assert AbstractEnv.str_or_byte(b"x") == AbstractEnv.str_or_byte("x") == "x"
    with pytest.raises(NotImplementedError):
        env.load("p")


def test_gcs_env_refuses_append_before_the_filesystem_sees_it(tmp_path):
    store = chip_smoke.SmokeStore(str(tmp_path / "store"))
    env = GCSEnv(BASE, fs=store)
    with pytest.raises(io.UnsupportedOperation):
        env.open_file(BASE + "/j.jsonl", "a")
    assert store.ops["append_refused"] == 0 and not env.exists(BASE + "/j.jsonl")
    # The store refuses it as well, and commits nothing a write raised in.
    with pytest.raises(NotImplementedError):
        store.open(BASE + "/j.jsonl", "a")
    with pytest.raises(RuntimeError), env.open_file(BASE + "/half.bin", "wb") as f:
        f.write(b"part")
        raise RuntimeError("the writer died")
    assert not env.exists(BASE + "/half.bin") and not hasattr(store, "mv")


# ------------------------------------------------------- exclusive_create


def test_one_of_eight_threads_wins_an_exclusive_create(tmp_path):
    store = chip_smoke.SmokeStore(str(tmp_path / "store"))
    env = GCSEnv(BASE, fs=store)
    path = BASE + "/runs/.run_claim"
    barrier = threading.Barrier(8)
    won = {}

    def claim(i):
        barrier.wait()
        won[i] = env.exclusive_create(str(i), path)

    threads = [threading.Thread(target=claim, args=(i,)) for i in range(8)]
    try:
        for t in threads:
            t.start()
    finally:
        for t in threads:
            t.join(30)
    winners = [i for i, ok in won.items() if ok]
    assert len(won) == 8 and len(winners) == 1
    assert env.load(path) == str(winners[0])
    assert store.puts == [path]


class StubFs:
    """An fsspec-shaped filesystem whose ``open`` for writing fails as
    ``error`` says (or, with ``TypeError``, refuses the precondition
    keyword)."""

    def __init__(self, error):
        self.error, self.files = error, {}

    def exists(self, path):
        return path in self.files

    def open(self, path, mode="r", **kw):
        if "w" in mode:
            if kw and self.error is TypeError:
                raise TypeError("unexpected keyword argument 'if_generation_match'")
            if kw and self.error is not None:
                raise self.error
            files = self.files

            class W(io.StringIO):
                def close(self):
                    files[path] = self.getvalue()
                    super().close()
            return W()
        return io.StringIO(self.files[path])


ERRORS = {"type_error": TypeError, "file_exists": FileExistsError("exists"),
          "412": OSError("412 Precondition Failed"),
          "generation": ValueError("At least one of the pre-conditions (generation) failed"),
          "precondition": OSError("precondition"), "io_error": OSError("disk full")}


@pytest.mark.parametrize("error", list(ERRORS))
def test_exclusive_create_error_paths_match_jax(error):
    results = {}
    for pkg in PACKAGES:
        env = PACKAGES[pkg][0](BASE, fs=StubFs(ERRORS[error]))
        out = []
        for data in ("a", "b"):
            try:
                out.append(env.exclusive_create(data, BASE + "/claim"))
            except Exception as e:  # noqa: BLE001 - the outcome compared
                out.append("{}: {}".format(type(e).__name__, e))
        results[pkg] = (out, env.fs.files)
    assert results["port"] == results["jax"]
    assert results["port"][0] == {"type_error": [True, False], "io_error": [
        "OSError: disk full"] * 2}.get(error, [False, False])


# ---------------------------------------------------------------- EnvSing


def test_env_sing_picks_gcs_for_a_gs_base_in_both_packages(monkeypatch, tmp_path):
    stub = types.ModuleType("gcsfs")
    stub.GCSFileSystem = memory_fs
    monkeypatch.setitem(sys.modules, "gcsfs", stub)
    monkeypatch.setenv("MAGGY_TPU_BASE_DIR", "gs://bucket/base")
    port, jax = EnvSing.get_instance(), JaxEnvSing.get_instance()
    assert isinstance(port, GCSEnv) and isinstance(jax, JaxGCSEnv)
    assert port.base_dir == jax.base_dir == "gs://bucket/base"
    assert isinstance(port.fs, MemoryFileSystem)
    EnvSing.reset()
    JaxEnvSing.reset()
    monkeypatch.setenv("MAGGY_TPU_BASE_DIR", str(tmp_path))
    port, jax = EnvSing.get_instance(), JaxEnvSing.get_instance()
    assert type(port) is LocalEnv and type(jax) is JaxLocalEnv
    assert port.base_dir == jax.base_dir == str(tmp_path)


def test_gcs_env_without_gcsfs_raises_in_both_packages(monkeypatch):
    monkeypatch.setitem(sys.modules, "gcsfs", None)
    messages = []
    for pkg in PACKAGES:
        with pytest.raises(ImportError) as err:
            PACKAGES[pkg][0](BASE)
        messages.append(str(err.value))
    assert messages[0] == messages[1] and "gcsfs" in messages[0]


# ------------------------------------------------------ the FINAL fast path


@pytest.mark.parametrize("prefetch", [True, False])
@pytest.mark.parametrize("kind", ["local", "gcs"])
def test_inline_final_path_matches_jax(kind, prefetch, tmp_path):
    if kind == "gcs":
        fs = memory_fs()
        EnvSing.set_instance(GCSEnv(BASE, fs=fs))
        JaxEnvSing.set_instance(JaxGCSEnv(BASE, fs=fs))
        dirs = BASE + "/port", BASE + "/jax"
    else:
        dirs = str(tmp_path / "port"), str(tmp_path / "jax")
    common = dict(name="inline", num_trials=4, optimizer="randomsearch", direction="max",
                  num_workers=2, seed=5, es_policy="none", prefetch=prefetch)
    drivers = []
    try:
        drivers.append(OptimizationDriver(OptimizationConfig(
            searchspace=Searchspace(lr=("DOUBLE", [0.0, 0.2])), experiment_dir=dirs[0],
            **common), "inline", 0))
        drivers.append(JaxDriver(JaxConfig(
            searchspace=JaxSearchspace(lr=("DOUBLE", [0.0, 0.2])), experiment_dir=dirs[1],
            health=False, **common), "inline", 0))
        port, jax = drivers
        assert port._inline_final_enabled == jax._inline_final_enabled \
            == (prefetch and kind == "local")
        assert port._prefetch_enabled == jax._prefetch_enabled == prefetch
    finally:
        for d in drivers:
            d.stop()


# ---------------------------------------------------- checkpoints and forks


def ckpt_scenario(exp_dir, env):
    """Saves, the skip rule, retention, restores, the parent restore and a
    fork's staging on ``exp_dir``; returns what each step saw."""
    def state(v):
        return {"w": torch.full((3,), float(v)), "opt": {"step": torch.tensor(int(v))},
                "n": int(v)}

    template = state(0)
    out = {}
    ck = ckpt.TrialCheckpointer(exp_dir + "/t1", max_to_keep=2)
    for step in (0, 1, 2):
        ck.save(step, state(step))
    ck.save(1, state(99))  # not newer than the latest kept: skipped
    out["kept"] = ckpt._steps(ck.path, ck.env)
    out["latest"] = [ck.latest_step(), ckpt.latest_checkpoint_step(exp_dir + "/t1")]
    out["newest"] = ck.restore(template)
    out["older"] = ck.restore(template, step=1)
    with pytest.raises(ValueError):
        ck.restore({"w": torch.zeros(4), "opt": {"step": torch.tensor(0)}, "n": 0})
    out["parent"] = ckpt.restore_parent_state(exp_dir, "t1", template)
    out["no_parent"] = ckpt.restore_parent_state(exp_dir, "t0", template)
    out["has"] = [ckpt.has_checkpoints(exp_dir + "/t1"), ckpt.has_checkpoints(exp_dir + "/t9")]
    out["staged"] = ckpt.fork_checkpoint(env, exp_dir, "t1", exp_dir + "/t2")
    out["staged_again"] = ckpt.fork_checkpoint(env, exp_dir, "t1", exp_dir + "/t2", step=1)
    out["missing"] = ckpt.fork_checkpoint(env, exp_dir, "t1", exp_dir + "/t3", step=7)
    child = ckpt.TrialCheckpointer(exp_dir + "/t2")
    out["child"] = child.restore(template)
    child.save(2, state(50))  # the staged step: skipped, as orbax does
    out["child_after"] = child.restore(template)
    out["child_steps"] = ckpt.latest_checkpoint_step_env(env, exp_dir + "/t2")
    return {k: ckpt._flat_tensors(v) if isinstance(v, dict) else v for k, v in out.items()}


def equal(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(equal(a[k], b[k]) for k in a)
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return a == b


@pytest.mark.parametrize("backend", ["memory", "smoke_store"])
def test_checkpoints_and_forks_in_a_store_equal_a_local_dirs(backend, tmp_path, monkeypatch):
    local_env = LocalEnv(str(tmp_path / "local"))
    EnvSing.set_instance(local_env)
    want = ckpt_scenario(str(tmp_path / "local" / "run"), local_env)
    cwd = tmp_path / "cwd"
    cwd.mkdir()
    monkeypatch.chdir(cwd)
    fs = make_fs(backend, tmp_path)
    env = GCSEnv(BASE, fs=fs)
    EnvSing.set_instance(env)
    got = ckpt_scenario(BASE + "/run", env)
    assert equal(got, want), (got, want)
    assert want["kept"] == [1, 2] and want["staged"] == 2 and want["staged_again"] == 1
    assert want["missing"] is None and want["no_parent"] is None
    # The store holds one object a step and the fork's marker; no tmp
    # object and nothing on the local disk.
    assert env.exists(BASE + "/run/t2/checkpoints/.fork_complete.2")
    assert env.ls(BASE + "/run/t1/checkpoints") == ["1", "2"]
    assert env.ls(BASE + "/run/t1/checkpoints/2") == ["state.pt"]
    assert os.listdir(cwd) == []
    if backend == "smoke_store":
        assert not [p for p in fs.puts if ".tmp" in p]


def test_the_jax_checkpointer_writes_a_gs_dir_locally_and_fails_where_the_port_does_not(
        tmp_path, monkeypatch):
    """ROADMAP queue 3 item 28: the JAX ``TrialCheckpointer`` makes the
    trial dir absolute, so ``gs://...`` lands under ``./gs:/`` and orbax's
    save then raises; the port's goes through the environment."""
    import jax.numpy as jnp
    from maggy_tpu.train.checkpoint import TrialCheckpointer as JaxCheckpointer

    monkeypatch.chdir(tmp_path)
    jax_ck = JaxCheckpointer("gs://bkt/runs/app_0/t1")
    try:
        assert (tmp_path / "gs:" / "bkt" / "runs" / "app_0" / "t1" / "checkpoints").is_dir()
        with pytest.raises(ValueError, match="gs:"):
            jax_ck.save(0, {"w": jnp.ones(3)})
    finally:
        try:
            jax_ck.close()
        except Exception:  # noqa: BLE001 - the failed save may leave it torn
            pass
    (tmp_path / "port").mkdir()
    monkeypatch.chdir(tmp_path / "port")
    env = GCSEnv("gs://bkt", fs=memory_fs())
    EnvSing.set_instance(env)
    port_ck = ckpt.TrialCheckpointer("gs://bkt/runs/app_0/t1")
    port_ck.save(0, {"w": torch.ones(3)})
    assert os.listdir(tmp_path / "port") == []
    assert port_ck.latest_step() == 0
    assert torch.equal(port_ck.restore({"w": torch.zeros(3)})["w"], torch.ones(3))


# ----------------------------------------------------------------- resume


@pytest.mark.parametrize("backend", ["memory", "smoke_store"])
def test_object_store_resume_reruns_only_the_torn_trial(backend, tmp_path, monkeypatch):
    """JAX ``tests/test_gcs_env.py:85-138`` through the port's ``lagom``:
    three trials, one finalized trial.json torn to 17 bytes, then a resume
    to six: two restored, the torn one re-run, three fresh."""
    count_dir = tmp_path / "counts"
    count_dir.mkdir()
    monkeypatch.setenv("MAGGY_TEST_COUNT_DIR", str(count_dir))
    monkeypatch.setenv("MAGGY_TPU_APP_ID", "gcsresume")
    monkeypatch.chdir(tmp_path)
    env = GCSEnv(BASE, fs=make_fs(backend, tmp_path))
    EnvSing.set_instance(env)

    def cfg(n, **kw):
        return OptimizationConfig(
            name="gcs_resume", num_trials=n, optimizer="randomsearch",
            searchspace=Searchspace(lr=("DOUBLE", [0.0, 0.2]), units=("INTEGER", [8, 64])),
            direction="max", num_workers=2, hb_interval=0.05, seed=5, es_policy="none",
            experiment_dir=BASE + "/runs", **kw)

    r1 = experiment.lagom(train_counting, cfg(3))
    assert r1["num_trials"] == 3
    exp_dir = BASE + "/runs/" + env.ls(BASE + "/runs")[0]
    torn = None
    for name in env.ls(exp_dir):
        path = "{}/{}/trial.json".format(exp_dir, name)
        if env.exists(path):
            torn = path
            env.dump(env.load(path)[:17], path)
            break
    assert torn is not None
    # A line an earlier incarnation logged: the resume keeps it first.
    env.dump("earlier line\n", exp_dir + "/maggy.log")
    r2 = experiment.lagom(train_counting, cfg(6, resume=True))
    assert r2["num_trials"] == 6
    assert json.loads(env.load(torn))["status"] == "FINALIZED"
    # Six configs ran, the torn one twice.
    runs = sorted(len(open(count_dir / name).read()) for name in os.listdir(count_dir))
    assert runs == [1, 1, 1, 1, 1, 2]
    # The journal, rewritten whole (the store refuses "a"), holds both
    # incarnations; maggy.log, rewritten whole, kept the earlier line.
    events = read_events(exp_dir + "/telemetry.jsonl", env=env)
    finalized = [e for e in events if e["ev"] == "trial" and e["phase"] == "finalized"]
    assert events.torn_lines == 0 and len(finalized) == 7
    log = env.load(exp_dir + "/maggy.log")
    assert log.startswith("earlier line\n") and "resume: skipping unreadable" in log
    assert not (tmp_path / "gs:").exists()


# ------------------------------------------------------------ TensorBoard


def train_scalars(lr, units, reporter):
    for step in range(3):
        value = (lr - 0.1) ** 2 + step / units
        tensorboard.add_scalar("loss", value, step=step)
        reporter.broadcast(-value, step=step)
    return {"metric": -value}


def decoded_events(env, run_dir, scratch):
    """{logdir relative to the run dir: [(step, tag, hparams) of every event
    but the version record]}, each event file read through ``env``."""
    out = {}
    for name in env.ls(run_dir):
        logdir = "{}/{}".format(run_dir, name) if name == "tensorboard" \
            else "{}/{}/tensorboard".format(run_dir, name)
        for fname in env.ls(logdir):
            if not fname.startswith(tensorboard.EVENT_FILE_PREFIX):
                continue
            local = os.path.join(scratch, "events")
            with env.open_file(logdir + "/" + fname, "rb") as f, open(local, "wb") as out_f:
                out_f.write(f.read())
            events = [chip_smoke.decode_event(raw) for raw in iter_tfrecord(local)]
            assert events[0]["file_version"] == tensorboard.FILE_VERSION
            out.setdefault(logdir[len(run_dir) + 1:], []).extend(
                (e["step"], tag, plugin) for e in events[1:] for tag, _, plugin in e["values"])
    return {k: sorted(v, key=repr) for k, v in out.items()}


def test_a_sweeps_event_files_in_a_store_equal_a_local_runs(tmp_path, monkeypatch):
    monkeypatch.setenv("MAGGY_TPU_APP_ID", "tbstore")
    scratch = tmp_path / "scratch"
    scratch.mkdir()

    def sweep(env, exp_dir):
        EnvSing.set_instance(env)
        try:
            result = experiment.lagom(train_scalars, OptimizationConfig(
                name="tb_store", num_trials=3, optimizer="randomsearch",
                searchspace=Searchspace(lr=("DOUBLE", [0.0, 0.2]),
                                        units=("INTEGER", [8, 64])),
                direction="max", num_workers=1, hb_interval=0.05, seed=5, es_policy="none",
                experiment_dir=exp_dir))
            (run,) = [n for n in env.ls(exp_dir)]
            return result, decoded_events(env, exp_dir + "/" + run, str(scratch))
        finally:
            EnvSing.reset()

    local_result, local = sweep(LocalEnv(str(tmp_path / "local")), str(tmp_path / "local"))
    monkeypatch.chdir(scratch)
    store_result, stored = sweep(GCSEnv(BASE, fs=chip_smoke.SmokeStore(str(tmp_path / "s"))),
                                 BASE + "/tb")
    assert store_result["num_trials"] == local_result["num_trials"] == 3
    assert stored == local
    trials = [k for k in local if k != "tensorboard"]
    assert len(trials) == 3 and all(
        sorted(step for step, tag, _ in local[k] if tag == "loss") == [0, 1, 2] for k in trials)
    assert any(tag.startswith("telemetry/") for _, tag, _ in local["tensorboard"])
    assert not (scratch / "gs:").exists() and os.listdir(scratch) == ["events"]
