"""The port's examples (``maggy_tpu_torch/examples``) against the JAX
package's (``examples/*.py``): each one's configuration, search space,
optimizer and seeded data equal; the seeded sweeps' parameter sequences
(and the LOCO study's trial set) equal through both packages' lagom; each
port example end to end on the CPU with the JAX CI's smoke arguments; the
``python -m`` entry with JAX and the JAX package unimportable; and
``train.optim.sgd`` against ``optax.sgd``."""

import contextlib
import dataclasses
import importlib
import importlib.util
import inspect
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import textwrap
import types

import numpy as np
import pytest
import torch

import maggy_tpu.experiment as jax_experiment
import maggy_tpu_torch.experiment as port_experiment
from maggy_tpu.core.environment.singleton import EnvSing as JaxEnvSing
from maggy_tpu_torch.core.environment.singleton import EnvSing

pytestmark = [pytest.mark.torch, pytest.mark.timeout(90)]

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: Each example with the JAX CI's smoke arguments (tests/test_examples.py).
SMOKE = {
    "mnist_hpo": ["--trials", "2", "--workers", "2"],
    "bert_glue_hpo": ["--trials", "2"],
    "llama_lora_sweep": ["--trials", "2", "--resource-max", "1"],
    "resnet_cifar_asha": ["--trials", "2", "--resource-max", "1", "--workers", "2"],
    "titanic_ablation": [],
    "vit_cifar_hpo": ["--trials", "2"],
    "distributed_training": [],
    "pbt_sweep": ["--population", "2", "--generations", "2", "--workers", "2"],
}
#: The seeded arrays each example builds at import.
DATA = {"mnist_hpo": ("X_TRAIN", "Y_TRAIN"), "bert_glue_hpo": ("TOKENS", "LABELS"),
        "llama_lora_sweep": ("CORPUS",), "resnet_cifar_asha": ("X_TRAIN", "Y_TRAIN"),
        "vit_cifar_hpo": ("X_TRAIN", "Y_TRAIN"), "pbt_sweep": ("DATA_X", "DATA_Y")}
#: Fields where the port's model of devices holds (ROADMAP queue 3 item
#: 11): one rank a device, on the device the port names.
DEVICE_FIELDS = {"mesh_shape", "device"}
#: What the ``python -m`` entry may not import.
BANNED = ("jax", "jaxlib", "flax", "optax", "orbax", "msgpack", "sklearn", "maggy_tpu")
#: What the stubbed lagom returns: the keys the examples' mains print.
STUB_RESULT = {"best_val": 0.5, "best_hp": {"x": 1}, "num_trials": 3, "worst_hp": {"x": 0},
               "worst_val": 0.25, "average_metric": 0.75}

_JAX_MODULES = {}


def jax_example(name):
    """``examples/<name>.py`` loaded as a module (its import adds the repo
    to sys.path and builds its seeded data)."""
    if name not in _JAX_MODULES:
        spec = importlib.util.spec_from_file_location(
            "jax_example_" + name, os.path.join(ROOT, "examples", name + ".py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _JAX_MODULES[name] = mod
    return _JAX_MODULES[name]


def port_example(name):
    return importlib.import_module("maggy_tpu_torch.examples." + name)


@pytest.fixture
def dirs(tmp_path, monkeypatch):
    """Experiment and registry roots and temporary files under tmp_path,
    each package's environment singleton rebuilt over them; trials on the
    CPU; two intra-op threads (the test runs beside other workers)."""
    monkeypatch.setenv("MAGGY_TPU_BASE_DIR", str(tmp_path / "exp"))
    monkeypatch.setenv("MAGGY_TPU_REGISTRY_ROOT", str(tmp_path / "registry"))
    monkeypatch.setenv("MAGGY_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    EnvSing.reset()
    JaxEnvSing.reset()
    try:
        yield tmp_path
    finally:
        EnvSing.reset()
        JaxEnvSing.reset()
        torch.set_num_threads(threads)


def registry(root, key):
    """Each package registers its example's dataset in a registry of its
    own, so both get the same version."""
    return str(root / (key + "_registry"))


def recorded(monkeypatch, name, argv, root):
    """Run both packages' ``main`` with lagom stubbed: (jax (train_fn,
    config), port (train_fn, config), jax printed, port printed)."""
    calls, out = {}, {}
    for key, package, mod in (("jax", jax_experiment, jax_example(name)),
                              ("port", port_experiment, port_example(name))):
        def lagom(train_fn, config, key=key):
            calls[key] = (train_fn, config)
            return dict(STUB_RESULT)

        buf = io.StringIO()
        with monkeypatch.context() as m, contextlib.redirect_stdout(buf):
            m.setenv("MAGGY_TPU_REGISTRY_ROOT", registry(root, key))
            m.setattr(package, "lagom", lagom)
            m.setattr(sys, "argv", [name] + argv)
            if key == "jax":
                mod.main()
            else:
                mod.main(argv)
        out[key] = buf.getvalue()
    return calls["jax"], calls["port"], out["jax"], out["port"]


def optimizer_args(opt):
    """A controller object's class name and constructor arguments (those
    it keeps as attributes)."""
    names = [p for p in inspect.signature(type(opt).__init__).parameters if p != "self"]
    return type(opt).__name__, {n: getattr(opt, n) for n in names if hasattr(opt, n)}


def study_fields(study):
    return {"name": study.name, "version": study.version, "label": study.label_name,
            "features": sorted(study.features.included_features),
            "layers": sorted(study.model.layers.included_layers),
            "groups": sorted(map(sorted, study.model.layers.included_groups))}


@pytest.mark.parametrize("name", sorted(SMOKE))
def test_configs_and_data_equal_the_jax_examples(name, dirs, monkeypatch):
    (jfn, jcfg), (pfn, pcfg), jout, pout = recorded(monkeypatch, name, [], dirs)
    assert jout == pout  # the same lines from the same result
    assert type(jcfg).__name__ == type(pcfg).__name__
    assert list(inspect.signature(jfn).parameters) == list(inspect.signature(pfn).parameters)
    jfields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    pfields = {f.name: getattr(pcfg, f.name) for f in dataclasses.fields(pcfg)}
    common = sorted(set(jfields) & set(pfields) - DEVICE_FIELDS)
    assert {"name", "num_workers"} <= set(common)
    for field in common:
        j, p = jfields[field], pfields[field]
        if field == "searchspace":
            assert (j is None) == (p is None)
            if j is not None:
                assert j.to_dict() == p.to_dict()
        elif field == "optimizer" and not isinstance(j, str):
            assert optimizer_args(j) == optimizer_args(p)
        elif field == "ablation_study":
            assert study_fields(j) == study_fields(p)
        else:
            assert j == p, field
    if name == "distributed_training":
        # One rank a device: a world of one on the device the port names.
        assert pcfg.mesh_shape == {"data": pcfg.num_workers} and pcfg.device == "cpu"
    port, jax_mod = port_example(name), jax_example(name)
    for attr in DATA.get(name, ()):
        a, b = getattr(jax_mod, attr), getattr(port, attr)
        assert a.dtype == b.dtype and np.array_equal(a, b), attr
    if name == "titanic_ablation":
        jX, jy = jax_mod.make_titanic_like()
        pX, py = port.make_titanic_like()
        assert sorted(jX) == sorted(pX) and np.array_equal(jy, py)
        assert all(np.array_equal(jX[f], pX[f]) for f in jX)
        jax_mod.write_dataset_tfrecord(str(dirs / "jax.tfrecord"))
        port.write_dataset_tfrecord(str(dirs / "port.tfrecord"))
        assert (dirs / "jax.tfrecord").read_bytes() == (dirs / "port.tfrecord").read_bytes()
    if name == "distributed_training":
        assert distributed_data(jax_mod, monkeypatch, jax=True) == \
            distributed_data(port, monkeypatch, jax=False)


class _Captured(Exception):
    pass


def distributed_data(mod, monkeypatch, jax):
    """The arrays ``distributed_training``'s train_fn hands its batch
    iterator (built inside the function), with training stubbed out."""
    seen = {}

    def iterator(data, **kw):
        seen.update(data=data, kw=kw)
        raise _Captured

    monkeypatch.setattr(mod, "ShardedBatchIterator", iterator)
    if jax:
        monkeypatch.setattr(mod, "init_train_state", lambda *a, **k: (None, None, None))
        monkeypatch.setattr(mod, "make_train_step", lambda *a, **k: None)
    else:
        monkeypatch.setattr(mod, "Trainer", lambda *a, **k: types.SimpleNamespace(
            init=lambda **kw: None))
    env = types.SimpleNamespace(mesh=None, shard_count=1, current_shard=0)
    with pytest.raises(_Captured):
        mod.train_fn(env)
    kw = {k: v for k, v in seen["kw"].items() if k not in ("mesh", "env")}
    return ({k: (v.dtype.str, v.tobytes()) for k, v in seen["data"].items()},
            sorted(kw.items()))


# ------------------------------------------------------ the sweeps as a whole


def _metric(reporter, **p):
    reporter.broadcast(float(p["lr"]), step=0)
    return {"metric": -(np.log10(p["lr"]) + 2.5) ** 2
            + 1e-3 * sum(float(v) for k, v in p.items() if k != "lr")}


def cf_mnist(kernel, pool, dropout, lr, reporter):
    return _metric(reporter, kernel=kernel, pool=pool, dropout=dropout, lr=lr)


def cf_bert(lr, warmup_frac, batch, reporter):
    return _metric(reporter, lr=lr, warmup_frac=warmup_frac, batch=batch)


def cf_llama(lora_rank, lora_alpha, lr, budget, reporter):
    return _metric(reporter, lora_rank=lora_rank, lora_alpha=lora_alpha, lr=lr, budget=budget)


def cf_resnet(lr, width, weight_decay, budget, reporter):
    return _metric(reporter, lr=lr, width=width, weight_decay=weight_decay, budget=budget)


def cf_vit(lr, width, patch, reporter):
    return _metric(reporter, lr=lr, width=width, patch=patch)


def cf_pbt(lr, wd, generation, member, budget, reporter):
    return _metric(reporter, lr=lr, wd=wd, generation=generation, member=member)


def cf_titanic(dataset_function, model_function, ablated_feature, ablated_layer, reporter):
    reporter.broadcast(0.0, step=0)
    return {"metric": float(len(str(ablated_feature)) + len(str(ablated_layer)))}


SWEEPS = {"mnist_hpo": cf_mnist, "bert_glue_hpo": cf_bert, "llama_lora_sweep": cf_llama,
          "resnet_cifar_asha": cf_resnet, "vit_cifar_hpo": cf_vit, "pbt_sweep": cf_pbt,
          "titanic_ablation": cf_titanic}


def finished_trials(exp_dir):
    trials = []
    for dirpath, _, names in os.walk(exp_dir):
        if "trial.json" in names:
            with open(os.path.join(dirpath, "trial.json")) as f:
                trials.append(json.load(f))
    return trials


def param_sequence(exp_dir):
    trials = sorted(finished_trials(exp_dir), key=lambda t: t["start"])  # one runner
    return [(t["params"], t["info_dict"].get("sample_type")) for t in trials]


@pytest.mark.parametrize("name", sorted(SWEEPS))
def test_seeded_sweeps_give_the_jax_examples_parameters(name, dirs, monkeypatch):
    """Each example's own configuration (its defaults) through both
    packages' lagom on one runner, prefetch off, with a closed-form train
    function: the same parameters in the same order (for the LOCO study,
    the same trials)."""
    (_, jcfg), (_, pcfg), _, _ = recorded(monkeypatch, name, [], dirs)
    seqs = {}
    for key, package, cfg in (("jax", jax_experiment, jcfg), ("port", port_experiment, pcfg)):
        exp_dir = str(dirs / (key + "_sweep"))
        cfg = dataclasses.replace(cfg, num_workers=1, prefetch=False, hb_interval=0.05,
                                  experiment_dir=exp_dir)
        with monkeypatch.context() as m:
            m.setenv("MAGGY_TPU_REGISTRY_ROOT", registry(dirs, key))
            package.lagom(SWEEPS[name], cfg)
        seqs[key] = param_sequence(exp_dir)
    if name == "titanic_ablation":
        key = lambda seq: sorted(json.dumps(p, sort_keys=True) for p, _ in seq)  # noqa: E731
        assert len(seqs["port"]) == 9 and key(seqs["port"]) == key(seqs["jax"])
    else:
        assert len(seqs["port"]) >= pcfg.num_trials and seqs["port"] == seqs["jax"]


# ---------------------------------------------------- each example end to end

#: What each smoke run finalizes, and the start of the line its main prints.
SMOKE_TRIALS = {"mnist_hpo": 2, "bert_glue_hpo": 2, "llama_lora_sweep": 2,
                "resnet_cifar_asha": 2, "titanic_ablation": 9, "vit_cifar_hpo": 2,
                "distributed_training": 0, "pbt_sweep": 4}
SMOKE_LINE = {"mnist_hpo": "Best: ", "bert_glue_hpo": "Best accuracy: ",
              "llama_lora_sweep": "Best: ", "resnet_cifar_asha": "Best: ",
              "titanic_ablation": "Worst (most important component): ",
              "vit_cifar_hpo": "Best: ", "distributed_training": "Average final loss across workers: ",
              "pbt_sweep": "Best: "}


@pytest.mark.parametrize("name", sorted(SMOKE))
def test_port_example_runs_end_to_end_on_the_cpu(name, dirs, capsys):
    result = port_example(name).main(list(SMOKE[name]))
    lines = capsys.readouterr().out.splitlines()
    assert any(line.startswith(SMOKE_LINE[name]) for line in lines), lines
    if name == "distributed_training":
        assert result["num_workers"] == 1 and math.isfinite(result["average_metric"])
        return
    trials = finished_trials(str(dirs / "exp"))
    assert len(trials) == result["num_trials"] == SMOKE_TRIALS[name]
    assert all(t["status"] == "FINALIZED" and math.isfinite(t["final_metric"]) for t in trials)
    assert math.isfinite(result["best_val"])
    if name == "titanic_ablation":
        assert result["worst_hp"]["ablated_feature"] == "sex"


_CLI = textwrap.dedent("""
    import importlib.abc, importlib.machinery, runpy, sys

    BANNED = {banned!r}

    class Refuse(importlib.abc.Loader):
        def create_module(self, spec):
            raise ImportError("blocked import: " + spec.name)

        def exec_module(self, module):
            pass

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BANNED:
                return importlib.machinery.ModuleSpec(name, Refuse())
            return None

    sys.meta_path.insert(0, Block())
    for name in list(sys.modules):
        if name.split(".")[0] in BANNED:
            del sys.modules[name]
    sys.path.insert(0, {root!r})
    sys.argv = ["mnist_hpo", "--trials", "2", "--workers", "2"]
    runpy.run_module("maggy_tpu_torch.examples.mnist_hpo", run_name="__main__")
    print("BANNED_IMPORTED", sorted(m for m in sys.modules if m.split(".")[0] in BANNED))
""")


@pytest.mark.timeout(120)
def test_cli_entry_runs_with_jax_refused(tmp_path):
    script = tmp_path / "cli.py"
    script.write_text(_CLI.format(banned=BANNED, root=ROOT))
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX", "XLA"))}
    env.update(MAGGY_TPU_TORCH_DEVICE="cpu", MAGGY_TPU_BASE_DIR=str(tmp_path / "exp"),
               OMP_NUM_THREADS="2")
    proc = subprocess.Popen([sys.executable, str(script)], env=env, cwd=str(tmp_path),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        out, err = proc.communicate(timeout=100)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-3000:]
    lines = out.splitlines()
    assert any(line.startswith("Best: ") for line in lines), out
    assert "BANNED_IMPORTED []" in lines, out
    trials = finished_trials(str(tmp_path / "exp"))
    assert len(trials) == 2 and all(t["status"] == "FINALIZED" for t in trials)


# ------------------------------------------------------------------ sgd


@pytest.mark.parametrize("momentum,nesterov", [(0.9, False), (0.0, False), (0.9, True),
                                               (0.0, True)])
def test_sgd_matches_optax_sgd(momentum, nesterov):
    import jax.numpy as jnp
    import optax

    from maggy_tpu_torch.train import sgd

    rng = np.random.default_rng(0)
    init = [rng.normal(size=(4, 3)).astype(np.float32), rng.normal(size=(5,)).astype(np.float32)]
    grads = [[rng.normal(size=p.shape).astype(np.float32) for p in init] for _ in range(5)]

    tx = optax.sgd(0.05, momentum=momentum, nesterov=nesterov)
    jparams = [jnp.asarray(p) for p in init]
    state = tx.init(jparams)
    params = [torch.nn.Parameter(torch.as_tensor(p.copy())) for p in init]
    opt, sched = sgd(0.05, momentum=momentum, nesterov=nesterov)(params)
    for g in grads:
        updates, state = tx.update([jnp.asarray(x) for x in g], state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for p, x in zip(params, g):
            p.grad = torch.as_tensor(x)
        opt.step()
        sched.step()
    for p, j in zip(params, jparams):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(j), rtol=0, atol=1e-6)
