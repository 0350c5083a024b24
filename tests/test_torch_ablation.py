"""The port's ablation studies against maggy_tpu's, on the CPU.

Counterparts of ``tests/test_ablation.py``: the study spec and its
``to_dict``; LOCO's ordered schedule and trial ids; the resolution of
features, layers, groups, prefixes and custom models through both
packages' resolvers; ``filter_layers``; ``AblatableSequential`` against the
Flax one from converted params (fp32 on both sides, outputs within 1e-5 of
the largest); ``lagom(AblationConfig)`` with tests/test_ablation.py's toy
study through both packages (the same trial count, ids and best and worst
trials); examples/titanic_ablation.py's study trained by the port's Trainer
(``sex`` the worst ablation); and the refusals. Resume: the JAX ablator has
no ``restore_from_finals``, so ``AblationConfig(resume=True)`` raises
there (ROADMAP queue 3 item 20); the port's LOCO drops what ran.
"""

import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from maggy_tpu import AblationConfig as JaxAblationConfig
from maggy_tpu import experiment as jax_experiment
from maggy_tpu.ablation import AblationStudy as JaxStudy
from maggy_tpu.ablation.ablator import LOCO as JaxLOCO
from maggy_tpu.core.environment import EnvSing as JaxEnvSing
from maggy_tpu.core.environment.abstractenvironment import LocalEnv as JaxLocalEnv
from maggy_tpu.models import surgery as jax_surgery

from maggy_tpu_torch import AblationConfig, experiment
from maggy_tpu_torch.ablation import AblationStudy
from maggy_tpu_torch.ablation.ablator import LOCO
from maggy_tpu_torch.ablation.ablator.loco import default_dataset_generator
from maggy_tpu_torch.core.driver.ablation_driver import AblationDriver
from maggy_tpu_torch.core.environment import EnvSing
from maggy_tpu_torch.core.environment.abstractenvironment import LocalEnv
from maggy_tpu_torch.models import surgery
from maggy_tpu_torch.train import (DatasetRegistry, Trainer, adam, clear_warm,
                                   cross_entropy_loss)
from maggy_tpu_torch.train.tfrecord import write_tfrecord

pytestmark = [pytest.mark.torch, pytest.mark.timeout(90)]

OUT_TOL = 1e-5


@pytest.fixture(autouse=True)
def envs(tmp_path):
    EnvSing.set_instance(LocalEnv(base_dir=str(tmp_path / "port")))
    JaxEnvSing.set_instance(JaxLocalEnv(base_dir=str(tmp_path / "jax")))
    clear_warm()
    yield
    EnvSing.reset()
    JaxEnvSing.reset()
    clear_warm()


# tests/test_ablation.py's toy study: generators of plain dicts, shared by
# both packages.
FEATURES = ["age", "fare", "sex"]


def toy_dataset_generator(ablated_feature=None):
    return {"columns": [f for f in FEATURES if f != ablated_feature]}


def toy_model_generator(ablated_layers=frozenset()):
    layers = ["conv_a", "conv_b", "dense_1", "dense_2", "dense_3"]
    return {"layers": [n for n in layers if not any(n.startswith(p) for p in ablated_layers)]}


def wide_model_generator(ablated_layers=frozenset()):
    return {"layers": ["wide"]}


def make_study(cls):
    study = cls("toy", 1, "label", dataset_generator=toy_dataset_generator)
    study.features.include("age", "fare")
    study.model.set_base_model_generator(toy_model_generator)
    study.model.layers.include("dense_1")
    study.model.layers.include_groups(["dense_2", "dense_3"])
    study.model.layers.include_groups(prefix="conv")
    study.model.add_custom_model_generator("wide", wide_model_generator)
    return study


def toy_train_fn(dataset_function, model_function, ablated_feature, ablated_layer,
                 reporter=None):
    return 0.1 * len(dataset_function()["columns"]) + 0.05 * len(model_function()["layers"])


def schedule(loco):
    loco.initialize()
    return [loco.get_trial() for _ in range(loco.get_number_of_trials())]


# ---------------------------------------------------------------- the spec


def test_study_spec_and_to_dict_equal_jax():
    ours, theirs = make_study(AblationStudy), make_study(JaxStudy)
    assert ours.to_dict() == theirs.to_dict()
    ours.features.exclude("age")
    theirs.features.exclude("age")
    ours.model.layers.exclude_groups(prefix="conv")
    theirs.model.layers.exclude_groups(prefix="conv")
    assert ours.to_dict() == theirs.to_dict()
    assert ours.model.layers.list_all() == ["dense_1", ["dense_2", "dense_3"]]
    for study in (AblationStudy(), JaxStudy()):
        with pytest.raises(ValueError, match=">= 2"):
            study.model.layers.include_groups(["single"])


def test_loco_schedule_params_and_ids_equal_jax():
    ours, theirs = schedule(LOCO(make_study(AblationStudy))), schedule(JaxLOCO(make_study(JaxStudy)))
    # 1 base + 2 features + 1 layer + 2 groups (explicit + prefix) + 1 custom.
    assert len(ours) == len(theirs) == 7
    assert [t.params for t in ours] == [t.params for t in theirs]
    assert [t.trial_id for t in ours] == [t.trial_id for t in theirs]
    assert len({t.trial_id for t in ours}) == 7
    assert all(t.trial_type == "ablation" for t in ours)


def test_resolution_of_features_layers_groups_prefixes_and_custom_models_equals_jax():
    ours, theirs = LOCO(make_study(AblationStudy)), JaxLOCO(make_study(JaxStudy))
    resolve, jax_resolve = ours.make_resolver(), theirs.make_resolver()
    seen = set()
    for trial in schedule(ours):
        a, b = resolve(dict(trial.params)), jax_resolve(dict(trial.params))
        assert (a["ablated_feature"], a["ablated_layer"]) == (b["ablated_feature"],
                                                              b["ablated_layer"])
        assert a["dataset_function"]() == b["dataset_function"]()
        assert a["model_function"]() == b["model_function"]()
        seen.add(len(a["model_function"]()["layers"]))
    assert seen == {5, 4, 3, 1}  # base, a layer, a group or the prefix, custom


def test_default_dataset_generator_reads_train_set_and_the_registry(tmp_path, monkeypatch):
    data = {"age": np.arange(4.0), "fare": np.arange(4.0) * 2, "label": np.ones(4)}
    study = AblationStudy("toy", 1, "label", train_set=data)
    assert sorted(default_dataset_generator(study, "fare")) == ["age", "label"]
    path = str(tmp_path / "toy.tfrecord")
    write_tfrecord(path, ({k: float(v[i]) for k, v in data.items()} for i in range(4)))
    monkeypatch.setenv("MAGGY_TPU_REGISTRY_ROOT", str(tmp_path / "reg"))
    version = DatasetRegistry().register("toy", path)
    named = AblationStudy("toy", version, "label")
    out = default_dataset_generator(named, "age")
    assert sorted(out) == ["fare", "label"] and list(out["fare"]) == [0.0, 2.0, 4.0, 6.0]
    with pytest.raises(ValueError, match="train_set"):
        default_dataset_generator(AblationStudy("ghost", 1, "label"), "age")


# ---------------------------------------------------------- model surgery


@pytest.mark.parametrize("ablated", [frozenset(), {"b"}, {"b", "c"}, {"x"}, {"a"}, {"d"},
                                     {"b", "a", "d"}, {"c_"}, {"c"}])
def test_filter_layers_equals_jax(ablated):
    names = ["a", "b", "c_1", "c_2", "d"]
    assert surgery.filter_layers(names, frozenset(ablated)) == \
        jax_surgery.filter_layers(names, frozenset(ablated))


def _flax_layers():
    import flax.linen as fnn

    return (("input_dense", lambda: fnn.Dense(32)),
            ("hidden_1", lambda: fnn.Sequential([fnn.Dense(32), fnn.relu])),
            ("hidden_2", lambda: fnn.Sequential([fnn.Dense(32), fnn.relu])),
            ("head", lambda: fnn.Dense(2)))


def _hidden():
    return nn.Sequential(nn.Linear(32, 32), nn.ReLU())


def _lazy_input():
    return nn.LazyLinear(32)


def _head():
    return nn.Linear(32, 2)


TITANIC_LAYERS = (("input_dense", _lazy_input), ("hidden_1", _hidden), ("hidden_2", _hidden),
                  ("head", _head))


@pytest.mark.parametrize("ablated", [frozenset(), {"hidden_1"}, {"hidden_2"}, {"hidden"},
                                     {"input_dense", "head"}])
def test_ablatable_sequential_matches_flax_from_converted_params(ablated):
    """Each variant of examples/titanic_ablation.py's model: the Flax module
    initialized on 5 features, its params loaded into the port's kept
    layers (the lazy input layer materialized by one forward), the same
    outputs; only the kept layers hold parameters."""
    x = np.random.default_rng(0).normal(size=(16, 5)).astype(np.float32)
    flax_model = jax_surgery.ablatable_model_generator(_flax_layers(), frozenset(ablated))
    params = flax_model.init(jax.random.key(0), jnp.asarray(x[:1]))["params"]
    ref = np.asarray(flax_model.apply({"params": params}, jnp.asarray(x)))
    model = surgery.ablatable_model_generator(TITANIC_LAYERS, frozenset(ablated), device="cpu")
    assert model.identity is None  # lazy: a private warm slot
    with torch.no_grad():
        model(torch.from_numpy(x[:1]))
    model.load_state_dict(surgery.flax_to_state_dict(params, model))
    with torch.no_grad():
        out = model(torch.from_numpy(x)).numpy()
    assert np.abs(out - ref).max() <= OUT_TOL * max(1.0, np.abs(ref).max())
    n_flax = sum(np.asarray(leaf).size for leaf in jax.tree_util.tree_leaves(params))
    assert sum(p.numel() for p in model.parameters()) == n_flax
    assert model.identity == (surgery.AblatableSequential, model.kept,
                              tuple(m for n, m in TITANIC_LAYERS if n in model.kept))


def test_lazy_modules_materialize_in_trainer_init_before_the_optimizer():
    """A model built on the meta device with a lazy input layer: init
    without example inputs refuses; with them the layer takes the data's
    width before the optimizer is built, and the Trainer steps."""
    x = torch.randn(8, 4)
    batch = {"inputs": (x,), "labels": (x[:, 0] > 0).long()}

    def trainer():
        model = surgery.ablatable_model_generator(TITANIC_LAYERS)
        return Trainer(model, adam(1e-2), lambda lo, b: cross_entropy_loss(lo, b["labels"]),
                       device="cpu")

    with pytest.raises(ValueError, match="example_inputs"):
        trainer().init(seed=0)
    t = trainer().init(seed=0, example_inputs=batch["inputs"])
    assert t.model.layers["input_dense"].weight.shape == (32, 4)
    assert t.optimizer.param_groups[0]["params"][0].shape == (32, 4)
    losses = [float(t.step(batch)) for _ in range(5)]
    assert losses[-1] < losses[0]
    assert t._slot.key is None  # no identity: a private slot


# ------------------------------------------------------------- end to end


def _trial_ids(exp_root):
    return sorted(os.path.basename(os.path.dirname(p))
                  for p in glob.glob(os.path.join(exp_root, "**", "trial.json"), recursive=True))


def test_lagom_runs_the_toy_study_as_jax(tmp_path):
    kw = dict(name="loco_e2e", ablator="loco", direction="max", num_workers=2, hb_interval=0.05)
    theirs = jax_experiment.lagom(toy_train_fn, JaxAblationConfig(
        ablation_study=make_study(JaxStudy), experiment_dir=str(tmp_path / "jax"), **kw))
    ours = experiment.lagom(toy_train_fn, AblationConfig(
        ablation_study=make_study(AblationStudy), experiment_dir=str(tmp_path / "port"), **kw))
    assert ours["num_trials"] == theirs["num_trials"] == 7
    for key in ("best_hp", "best_val", "worst_hp", "worst_val"):
        assert ours[key] == pytest.approx(theirs[key]), key
    assert ours["best_hp"] == {"ablated_feature": "None", "ablated_layer": "None",
                               "model_key": "base"}
    assert ours["worst_hp"]["model_key"] == "wide"
    assert _trial_ids(tmp_path / "port") == _trial_ids(tmp_path / "jax")
    (exp_json,) = glob.glob(str(tmp_path / "port" / "*" / "experiment.json"))
    assert json.load(open(exp_json))["ablation_study"] == make_study(AblationStudy).to_dict()


def test_unknown_ablator_and_remote_pool_are_refused():
    with pytest.raises(ValueError, match="Unknown ablator"):
        AblationDriver(AblationConfig(ablation_study=make_study(AblationStudy), ablator="nope"),
                       "a", 0)
    with pytest.raises(ValueError, match="not supported for ablation studies"):
        AblationDriver(AblationConfig(ablation_study=make_study(AblationStudy), pool="remote"),
                       "a", 0)


def test_resume_reruns_only_what_did_not_finish_where_jax_raises(tmp_path, monkeypatch):
    """An interrupted study (a finished run whose last two trial.json were
    lost): the JAX driver's resume calls the ablator's missing
    restore_from_finals; the port's LOCO drops the five finalized trials
    and runs the two others once."""
    monkeypatch.setenv("MAGGY_TPU_APP_ID", "app-resume")
    calls = []

    def fn(dataset_function, model_function, ablated_feature, ablated_layer, reporter=None):
        calls.append((ablated_feature, str(ablated_layer)))
        return toy_train_fn(dataset_function, model_function, ablated_feature, ablated_layer)

    for name, lagom, config, study in (
            ("port", experiment.lagom, AblationConfig, AblationStudy),
            ("jax", jax_experiment.lagom, JaxAblationConfig, JaxStudy)):
        kw = dict(name="resume", ablation_study=make_study(study), num_workers=1,
                  hb_interval=0.05, experiment_dir=str(tmp_path / name))
        assert lagom(fn, config(**kw))["num_trials"] == 7
        for path in sorted(glob.glob(str(tmp_path / name / "*" / "*" / "trial.json")))[:2]:
            os.remove(path)
        calls.clear()
        if name == "jax":
            with pytest.raises(AttributeError, match="restore_from_finals"):
                lagom(fn, config(resume=True, **kw))
            continue
        result = lagom(fn, config(resume=True, **kw))
        assert len(calls) == 2 and len(set(calls)) == 2
        assert result["num_trials"] == 7 and len(_trial_ids(tmp_path / name)) == 7


# ------------------------------------------------------- the titanic study

TITANIC = ["pclass", "sex", "age", "fare", "embarked"]


def titanic_generator(ablated_layers=frozenset()):
    return surgery.ablatable_model_generator(TITANIC_LAYERS, ablated_layers)


def titanic_train_fn(dataset_function, model_function, ablated_feature, ablated_layer,
                     reporter=None):
    """examples/titanic_ablation.py's train_fn on the port: full batch,
    Adam 1e-2, 60 steps."""
    data = dataset_function()
    y = torch.as_tensor(np.asarray(data.pop("survived"), dtype=np.int64))
    x = torch.as_tensor(np.stack([data[c] for c in sorted(data)], axis=1))
    batch = {"inputs": (x,), "labels": y}
    trainer = Trainer(model_function(), adam(1e-2),
                      lambda logits, b: cross_entropy_loss(logits, b["labels"]),
                      device="cpu").init(seed=0, example_inputs=batch["inputs"])
    trainer.fit([batch] * 60, reporter=reporter, report_every=20)
    with torch.no_grad():
        acc = float((trainer.model(x).argmax(-1) == y).float().mean())
    return {"metric": acc, "params": sum(p.numel() for p in trainer.model.parameters())}


def test_titanic_study_on_the_port_finds_sex_the_most_important(tmp_path, monkeypatch):
    rng = np.random.default_rng(0)  # examples/titanic_ablation.py's make_titanic_like
    n = 2048
    X = {f: rng.normal(size=n).astype(np.float32) for f in TITANIC}
    logits = 1.5 * X["sex"] - 0.8 * X["pclass"] + 0.3 * X["fare"]
    y = (logits + 0.5 * rng.normal(size=n) > 0).astype(np.int32)
    path = str(tmp_path / "titanic.tfrecord")
    write_tfrecord(path, ({**{f: float(X[f][i]) for f in TITANIC}, "survived": int(y[i])}
                          for i in range(n)))
    monkeypatch.setenv("MAGGY_TPU_REGISTRY_ROOT", str(tmp_path / "reg"))
    version = DatasetRegistry().register("titanic", path)
    study = AblationStudy("titanic", version, "survived")
    study.features.include(*TITANIC)
    study.model.set_base_model_generator(titanic_generator)
    study.model.layers.include("hidden_1", "hidden_2")
    study.model.layers.include_groups(prefix="hidden")
    result = experiment.lagom(titanic_train_fn, AblationConfig(
        name="titanic", ablation_study=study, num_workers=3, hb_interval=0.05,
        experiment_dir=str(tmp_path / "exp")))
    assert result["num_trials"] == 9
    assert result["worst_hp"]["ablated_feature"] == "sex"
    assert result["best_val"] > 0.8
    trials = [json.load(open(p)) for p in glob.glob(str(tmp_path / "exp" / "*" / "*" /
                                                         ".outputs.json"))]
    assert sorted(t["params"] for t in trials) == sorted(
        [5 * 32 + 32 + 2 * (32 * 32 + 32) + 66] + [4 * 32 + 32 + 2 * 1056 + 66] * 5 +
        [5 * 32 + 32 + 1056 + 66] * 2 + [5 * 32 + 32 + 66])
