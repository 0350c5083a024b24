"""The port's TensorBoard writer (``maggy_tpu_torch/tensorboard.py``) against
the JAX package's (``maggy_tpu/tensorboard.py``, which in this environment
writes through the installed ``tensorboard`` package).

Every test feeds the same inputs through both modules and decodes both
event files with TensorBoard's own loader and the HParams plugin's protos;
the records must be equal field by field, apart from wall times and the
``*_time_secs`` fields. The JAX header's ``source_metadata`` (the name of
the writer) is the one field the port does not write. One test writes the
port's files in a subprocess that refuses ``tensorboard`` and
``google.protobuf``, as on the card's machine, and reads them here.
"""

from __future__ import annotations

import glob
import json
import os
import subprocess
import sys
import textwrap
import threading

import pytest
from tensorboard.backend.event_processing.event_file_loader import EventFileLoader
from tensorboard.compat.proto import event_pb2
from tensorboard.plugins.hparams import metadata as hp_metadata
from tensorboard.plugins.hparams import plugin_data_pb2

from maggy_tpu import tensorboard as jax_tb
from maggy_tpu.gang import GangSpec as JaxGangSpec
from maggy_tpu.searchspace import Searchspace as JaxSearchspace
from maggy_tpu_torch import OptimizationConfig, Searchspace, experiment
from maggy_tpu_torch import tensorboard as tb
from maggy_tpu_torch.gang import GangSpec
from maggy_tpu_torch.telemetry import profiling

pytestmark = [pytest.mark.torch, pytest.mark.timeout(120)]

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_TIME_FIELDS = ("start_time_secs", "end_time_secs", "time_created_secs")


@pytest.fixture(autouse=True)
def _close_writers():
    yield
    tb._close()
    jax_tb._close()


def _event_files(logdir):
    files = sorted(glob.glob(os.path.join(logdir, tb.EVENT_FILE_PREFIX + "*")))
    assert files, "no event file in {}".format(logdir)
    return files


def _records(logdir):
    """Every event of every file in ``logdir`` (in file order), wall times
    zeroed, the header's writer name dropped, and each HParams record's
    plugin content decoded (its ``*_time_secs`` cleared) into
    ``(event, [HParamsPluginData or None per value])``."""
    out = []
    for path in _event_files(logdir):
        for event in EventFileLoader(path).Load():
            event.wall_time = 0.0
            event.ClearField("source_metadata")
            plugin = []
            for value in event.summary.value:
                pd = value.metadata.plugin_data
                if pd.plugin_name != hp_metadata.PLUGIN_NAME:
                    plugin.append(None)
                    continue
                data = plugin_data_pb2.HParamsPluginData.FromString(pd.content)
                for which in ("experiment", "session_start_info", "session_end_info"):
                    if data.HasField(which):
                        msg = getattr(data, which)
                        for field in _TIME_FIELDS:
                            if field in msg.DESCRIPTOR.fields_by_name:
                                msg.ClearField(field)
                plugin.append(data)
                pd.content = b""
            out.append((event, plugin))
    return out


def _assert_same_records(jax_dir, port_dir):
    ref, ours = _records(jax_dir), _records(port_dir)
    assert len(ours) == len(ref)
    for (ev_ref, pd_ref), (ev_ours, pd_ours) in zip(ref, ours):
        assert ev_ours == ev_ref
        assert pd_ours == pd_ref
    return ours


def _tags(records):
    return [v.tag for ev, _ in records for v in ev.summary.value]


def _scalars(records, tag):
    """``(step, value)`` of every ``tag`` scalar (the loader migrates a
    ``simple_value`` into a one-element tensor)."""
    from tensorboard.util import tensor_util

    return [(ev.step, float(tensor_util.make_ndarray(v.tensor).reshape(())))
            for ev, _ in records for v in ev.summary.value if v.tag == tag]


def _both(tmp_path, fn):
    """Run ``fn(module, logdir)`` through the JAX module, then the port's."""
    dirs = {}
    for name, mod in (("jax", jax_tb), ("port", tb)):
        dirs[name] = str(tmp_path / name)
        fn(mod, dirs[name])
    return dirs["jax"], dirs["port"]


def test_scalars_match_the_jax_writer(tmp_path):
    def write(mod, logdir):
        mod._register(logdir)
        for step, value in ((0, 0.5), (1, -0.25), (7, 0.0), (2 ** 40, 3.5e8)):
            mod.add_scalar("loss", value, step=step)
        mod.add_scalar("acc", 1, step=3)
        mod._close()

    records = _assert_same_records(*_both(tmp_path, write))
    assert records[0][0].file_version == tb.FILE_VERSION
    assert _scalars(records, "loss") == [(0, 0.5), (1, -0.25), (7, 0.0), (2 ** 40, 3.5e8)]
    assert _scalars(records, "acc") == [(3, 1.0)]


def test_hparams_of_every_value_type_match(tmp_path):
    hparams = {"flag": True, "off": False, "units": 32, "zero": 0, "neg": -3,
               "lr": 0.01, "nil": 0.0, "act": "relu", "empty": "", "shape": [1, 2],
               "none": None}

    def write(mod, logdir):
        mod._register(logdir)
        mod.write_hparams(hparams, metrics={"metric": 0.75})
        mod._close()

    records = _assert_same_records(*_both(tmp_path, write))
    (start,) = [pd[0] for _, pd in records
                if pd and pd[0] is not None and pd[0].HasField("session_start_info")]
    got = start.session_start_info.hparams
    # bool before int: True is a bool_value, not the number 1.
    assert got["flag"].WhichOneof("kind") == "bool_value" and got["flag"].bool_value
    assert got["off"].WhichOneof("kind") == "bool_value" and not got["off"].bool_value
    assert got["units"].number_value == 32 and got["zero"].WhichOneof("kind") == "number_value"
    assert got["shape"].string_value == "[1, 2]" and got["none"].string_value == "None"
    assert "metric" in _tags(records)


def test_session_end_on_close_and_on_the_next_register(tmp_path):
    def write(mod, logdir):
        mod._register(os.path.join(logdir, "a"))
        mod.add_scalar("m", 1.0, 0)
        mod._register(os.path.join(logdir, "b"))  # closes a's session
        mod.add_scalar("m", 2.0, 0)
        mod._close()

    jax_dir, port_dir = _both(tmp_path, write)
    for sub in ("a", "b"):
        records = _assert_same_records(os.path.join(jax_dir, sub), os.path.join(port_dir, sub))
        assert _tags(records)[-1] == hp_metadata.SESSION_END_INFO_TAG
        (end,) = [pd[0] for _, pd in records if pd and pd[0] is not None]
        assert end.session_end_info.status == tb.STATUS_SUCCESS


def test_experiment_config_for_every_searchspace_type(tmp_path):
    spec = dict(lr=("DOUBLE", [0.0, 0.2]), wd=("DOUBLE_LOG", [1e-5, 1e-1]),
                units=("INTEGER", [8, 64]), drop=("DISCRETE", [0, 0.5, 1]),
                act=("CATEGORICAL", ["relu", "gelu"]))

    def write(mod, exp_dir):
        if mod is jax_tb:
            space = JaxSearchspace(gang=("GANG", [JaxGangSpec(1), JaxGangSpec(2)]), **spec)
        else:
            space = Searchspace(gang=("GANG", [GangSpec(1), GangSpec(2)]), **spec)
        mod.write_experiment_config(exp_dir, space)
        mod.write_experiment_config(exp_dir + "_none", None)

    jax_dir, port_dir = _both(tmp_path, write)
    records = _assert_same_records(os.path.join(jax_dir, "tensorboard"),
                                   os.path.join(port_dir, "tensorboard"))
    (exp,) = [pd[0].experiment for _, pd in records if pd and pd[0] is not None]
    infos = {i.name: i for i in exp.hparam_infos}
    assert set(infos) == set(spec) | {"gang"}
    assert infos["lr"].domain_interval.max_value == 0.2
    assert infos["units"].type == tb.DATA_TYPE_FLOAT64
    assert [v.number_value for v in infos["drop"].domain_discrete.values] == [0, 0.5, 1]
    assert infos["act"].type == infos["gang"].type == tb.DATA_TYPE_STRING
    assert [m.name.tag for m in exp.metric_infos] == ["metric"]
    assert not os.path.exists(os.path.join(port_dir + "_none", "tensorboard"))


def test_telemetry_scalars_match(tmp_path):
    snapshot = {"spans": {"handoff": {"median_ms": 1.5, "p95_ms": 3.25, "n": 12},
                          "early_stop_reaction": {"median_ms": None, "n": 0},
                          "trials": {"finalized": 6, "requeued": 1}}}

    def write(mod, exp_dir):
        mod.write_telemetry_scalars(exp_dir, snapshot)
        mod.write_telemetry_scalars(exp_dir + "_empty", {"spans": {}})

    jax_dir, port_dir = _both(tmp_path, write)
    records = _assert_same_records(os.path.join(jax_dir, "tensorboard"),
                                   os.path.join(port_dir, "tensorboard"))
    assert _tags(records) == sorted([
        "telemetry/handoff_median_ms", "telemetry/handoff_p95_ms", "telemetry/handoff_n",
        "telemetry/early_stop_reaction_n", "telemetry/trials_finalized",
        "telemetry/trials_requeued"])
    assert not os.path.exists(os.path.join(port_dir + "_empty", "tensorboard"))


def test_concurrent_runner_threads_are_isolated(tmp_path):
    """Mirrors ``tests/test_tensorboard.py``: trial runners are threads
    sharing the module; one runner's ``_register`` must not close or steal
    another's writer."""
    barrier = threading.Barrier(2)
    errors = []

    def runner(name):
        try:
            logdir = str(tmp_path / name)
            tb._register(logdir)
            barrier.wait(timeout=10)  # both writers now open
            assert tb.logdir() == logdir
            tb.add_scalar("m", float(len(name)), 0)
            barrier.wait(timeout=10)
            tb._close()
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=runner, args=(n,)) for n in ("aa", "bbb")]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    for name in ("aa", "bbb"):
        records = _records(str(tmp_path / name))
        assert _scalars(records, "m") == [(0, float(len(name)))]
        assert _tags(records)[-1] == hp_metadata.SESSION_END_INFO_TAG


def test_logdir_guard_and_calls_outside_a_trial():
    with pytest.raises(RuntimeError, match="logdir"):
        tb.logdir()
    tb.add_scalar("ignored", 1.0)  # no trial: a no-op, as the JAX module's
    tb.write_hparams({"lr": 0.1})


def test_encoder_bytes_equal_protobufs():
    """The hand encoder emits protobuf's own bytes for the messages without
    maps: a proto3 scalar at its default left out, a oneof member kept."""
    ev = event_pb2.Event(wall_time=12.5, file_version=tb.FILE_VERSION)
    assert tb.encode_event(12.5, file_version=tb.FILE_VERSION) == ev.SerializeToString()
    ev = event_pb2.Event(wall_time=1.0, step=3)
    ev.summary.value.add(tag="loss", simple_value=0.0)
    assert tb.encode_event(1.0, 3, summary=tb._scalar_summary("loss", 0.0)) == \
        ev.SerializeToString()
    assert tb._NULL_TENSOR == hp_metadata.NULL_TENSOR.SerializeToString()


class _StagingEnv:
    """An environment whose ``mem://`` paths land under a local root."""

    def __init__(self, root):
        self.root = root

    def open_file(self, path, mode="r"):
        assert path.startswith("mem://"), path
        real = os.path.join(self.root, path[len("mem://"):])
        os.makedirs(os.path.dirname(real), exist_ok=True)
        return open(real, mode)


def test_a_remote_logdir_is_staged_and_uploaded_at_close(tmp_path, monkeypatch):
    from maggy_tpu.core.environment import EnvSing as JaxEnvSing
    from maggy_tpu_torch.core.environment import EnvSing

    for sing in (JaxEnvSing, EnvSing):
        monkeypatch.setattr(sing, "get_instance",
                            classmethod(lambda cls: _StagingEnv(str(tmp_path / "remote"))))

    def write(mod, name):
        mod._register("mem://{}/trial/tensorboard".format(os.path.basename(name)))
        mod.add_scalar("loss", 0.5, 1)
        mod._close()

    _both(tmp_path, write)
    _assert_same_records(str(tmp_path / "remote" / "jax" / "trial" / "tensorboard"),
                         str(tmp_path / "remote" / "port" / "trial" / "tensorboard"))


def test_user_trace_goes_through_the_profiler_lock(tmp_path):
    tb._register(str(tmp_path / "tb"))
    tb.start_trace()
    with pytest.raises(RuntimeError, match="profiler"):
        # The process's profiler is held: a second trace refuses, as does
        # a trial's profile (it runs untraced).
        profiling.start_user_trace()
    with profiling.trial_profile(str(tmp_path / "other")) as path:
        assert path is None
    sum(i * i for i in range(1000))
    tb.stop_trace()
    (trace,) = glob.glob(str(tmp_path / "tb" / ("*" + profiling.TB_TRACE_SUFFIX)))
    with open(trace) as f:
        assert "traceEvents" in json.load(f)
    assert profiling._CAPTURE_LOCK.acquire(blocking=False)
    profiling._CAPTURE_LOCK.release()
    with pytest.raises(RuntimeError):
        tb.stop_trace()


_BLOCKED = textwrap.dedent("""
    import importlib.abc, importlib.machinery, json, os, sys

    # ``google`` itself may be a namespace package that site set up before
    # this hook: ``google.protobuf`` is what must stay out.
    BANNED = ("tensorboard", "google.protobuf", "jax", "maggy_tpu")

    def banned(name):
        return any(name == b or name.startswith(b + ".") for b in BANNED)

    class Refuse(importlib.abc.Loader):
        def create_module(self, spec):
            raise ImportError("blocked import: " + spec.name)

        def exec_module(self, module):
            pass

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if banned(name):
                return importlib.machinery.ModuleSpec(name, Refuse())
            return None

    sys.meta_path.insert(0, Block())
    sys.path.insert(0, {root!r})
    from maggy_tpu_torch import Searchspace
    from maggy_tpu_torch import tensorboard as tb

    out = {out!r}
    tb._register(os.path.join(out, "trial"))
    tb.write_hparams({{"lr": 0.1, "flag": True, "act": "relu"}})
    tb.add_scalar("loss", 0.5, step=2)
    tb._close()
    tb.write_experiment_config(out, Searchspace(lr=("DOUBLE", [0.0, 0.2]),
                                                act=("CATEGORICAL", ["relu", "gelu"])))
    tb.write_telemetry_scalars(out, {{"spans": {{"trials": {{"finalized": 3}}}}}})
    print(json.dumps(sorted(m for m in sys.modules if banned(m))))
""")


def test_files_written_without_tensorboard_or_protobuf_load_in_tensorboard(tmp_path):
    script = tmp_path / "blocked_tb.py"
    script.write_text(_BLOCKED.format(root=ROOT, out=str(tmp_path / "port")))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, str(script)], capture_output=True, text=True,
                          timeout=90, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []

    jax_tb._register(str(tmp_path / "jax" / "trial"))
    jax_tb.write_hparams({"lr": 0.1, "flag": True, "act": "relu"})
    jax_tb.add_scalar("loss", 0.5, step=2)
    jax_tb._close()
    jax_tb.write_experiment_config(str(tmp_path / "jax"), JaxSearchspace(
        lr=("DOUBLE", [0.0, 0.2]), act=("CATEGORICAL", ["relu", "gelu"])))
    jax_tb.write_telemetry_scalars(str(tmp_path / "jax"),
                                   {"spans": {"trials": {"finalized": 3}}})
    for sub in ("trial", "tensorboard"):
        _assert_same_records(str(tmp_path / "jax" / sub), str(tmp_path / "port" / sub))


def _trial(lr, units, reporter=None):
    for step in range(3):
        tb.add_scalar("loss", lr * (step + 1), step=step)
        if reporter is not None:
            reporter.broadcast(-lr * step, step=step)
    return {"metric": 1.0 - lr}


def test_a_port_sweep_gives_every_trial_dir_its_session(tmp_path):
    space = Searchspace(lr=("DOUBLE", [0.0, 0.1]), units=("INTEGER", [8, 64]))
    result = experiment.lagom(_trial, OptimizationConfig(
        name="tb_sweep", num_trials=4, optimizer="randomsearch", searchspace=space,
        direction="max", num_workers=2, hb_interval=0.05, seed=0, es_policy="none",
        experiment_dir=str(tmp_path)))
    assert result["num_trials"] == 4
    (exp_dir,) = glob.glob(str(tmp_path / "*" / ""))
    trial_dirs = sorted(os.path.dirname(p) for p in glob.glob(os.path.join(exp_dir, "*", ".hparams.json")))
    assert len(trial_dirs) == 4
    for trial_dir in trial_dirs:
        with open(os.path.join(trial_dir, ".hparams.json")) as f:
            params = json.load(f)
        records = _records(os.path.join(trial_dir, "tensorboard"))
        starts = [pd[0].session_start_info for _, pd in records
                  if pd and pd[0] is not None and pd[0].HasField("session_start_info")]
        assert len(starts) == 1
        assert {k: v.number_value for k, v in starts[0].hparams.items()} == \
            pytest.approx(params)
        assert [v for _, v in _scalars(records, "loss")] == \
            pytest.approx([params["lr"] * s for s in (1, 2, 3)])
        assert _tags(records)[-1] == hp_metadata.SESSION_END_INFO_TAG
    tags = _tags(_records(os.path.join(exp_dir, "tensorboard")))
    assert tags.count(hp_metadata.EXPERIMENT_TAG) == 1
    assert "telemetry/trials_finalized" in tags
