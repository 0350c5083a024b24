"""LOCO: Leave One Component Out.

Copy of ``maggy_tpu/ablation/ablator/loco.py`` (parity: reference
`maggy/ablation/ablator/loco.py` — schedule: 1 base trial + one per
included feature + per layer + per layer group + per custom model
(:31-39, :138-194); dataset generator dropping the ablated feature
(:41-80); model generator rebuilding the model minus the ablated
layer(s)/group/prefix (:82-136)). Trials carry declarative params
{"ablated_feature", "ablated_layer", "model_key"}, hashed by
``Trial._compute_id``'s ablation rule, so both packages give the same ids;
the executor-side resolver (``make_resolver``) maps them back to
``dataset_function``/``model_function`` callables through the study
object. Nothing is cut.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional

from maggy_tpu_torch.ablation.ablator.abstractablator import AbstractAblator
from maggy_tpu_torch.trial import Trial


class LOCO(AbstractAblator):
    def get_number_of_trials(self) -> int:
        study = self.ablation_study
        return (
            1
            + len(study.features.included_features)
            + len(study.model.layers.included_layers)
            + len(study.model.layers.included_groups)
            + len(study.model.custom_model_generators)
        )

    def initialize(self) -> None:
        study = self.ablation_study
        # Base trial: nothing ablated.
        self.trial_buffer.append(self._make_trial(None, None, "base"))
        for feature in sorted(study.features.included_features):
            self.trial_buffer.append(self._make_trial(feature, None, "base"))
        for layer in sorted(study.model.layers.included_layers):
            self.trial_buffer.append(self._make_trial(None, layer, "base"))
        for group in sorted(sorted(g) for g in study.model.layers.included_groups):
            self.trial_buffer.append(self._make_trial(None, list(group), "base"))
        for name in sorted(study.model.custom_model_generators):
            self.trial_buffer.append(self._make_trial(None, None, name))

    def _make_trial(self, feature, layer, model_key) -> Trial:
        params: Dict[str, Any] = {
            "ablated_feature": feature if feature is not None else "None",
            "ablated_layer": layer if layer is not None else "None",
            "model_key": model_key,
        }
        return Trial(params, trial_type="ablation")

    def get_trial(self, last_trial: Optional[Trial] = None) -> Optional[Trial]:
        return self.trial_buffer.pop(0) if self.trial_buffer else None

    # ------------------------------------------------- executor-side resolve

    def make_resolver(self):
        """Build the declarative-spec -> callables resolver the trial
        executor applies before invoking the user function."""
        return functools.partial(resolve_ablation_params, self.ablation_study)


def resolve_ablation_params(study, params: Dict[str, Any]) -> Dict[str, Any]:
    """Map {"ablated_feature", "ablated_layer", "model_key"} to concrete
    ``dataset_function`` / ``model_function`` callables.

    The user's train function signature is
    ``train_fn(dataset_function, model_function[, reporter])`` — the same
    shape the reference's executors call (`trial_executor.py:142-146`).
    """
    feature = params.get("ablated_feature", "None")
    layer = params.get("ablated_layer", "None")
    model_key = params.get("model_key", "base")
    feature = None if feature == "None" else feature
    layer = None if layer == "None" else layer

    if study.custom_dataset_generator is not None:
        dataset_function = functools.partial(
            study.custom_dataset_generator, ablated_feature=feature
        )
    else:
        dataset_function = functools.partial(
            default_dataset_generator, study, ablated_feature=feature
        )

    if model_key != "base":
        model_function = study.model.custom_model_generators[model_key]
    else:
        gen = study.model.base_model_generator
        if gen is None:
            raise ValueError("AblationStudy has no base_model_generator.")
        ablated = frozenset() if layer is None else (
            frozenset([layer]) if isinstance(layer, str) else frozenset(layer)
        )
        model_function = functools.partial(gen, ablated_layers=ablated)

    return {
        "dataset_function": dataset_function,
        "model_function": model_function,
        "ablated_feature": feature,
        "ablated_layer": layer,
    }


def default_dataset_generator(study, ablated_feature: Optional[str] = None):
    """Built-in feature dropping from the study's ``train_set`` (dict of
    arrays or a dataset path), else from the registry entry the study's
    (name, version) names: the local analogue of the reference reading the
    feature store minus the ablated feature (`loco.py:41-80`)."""
    src = getattr(study, "train_set", None)
    if src is None and getattr(study, "name", ""):
        # The reference resolves (training_dataset_name, version) through
        # the feature store (`loco.py:41-80`); here the same pair resolves
        # through the dataset registry (train/registry.py) — but only if
        # the name is actually registered, so an unregistered study keeps
        # the actionable "no dataset source" error below.
        from maggy_tpu_torch.train.registry import DatasetRegistry

        try:
            reg = DatasetRegistry()
            if study.version in reg.versions(study.name):
                src = "registry://{}@{}".format(study.name, study.version)
        except Exception:  # noqa: BLE001 - registry probe must not mask the error
            pass
    if src is None:
        raise ValueError(
            "No dataset source: pass train_set= (dict of arrays or a "
            "dataset path), training_dataset_name= registered in the "
            "dataset registry, or dataset_generator= to AblationStudy."
        )
    from maggy_tpu_torch.train.data import feature_dropping_generator

    # Cache the generator (and its loaded-path data) per SOURCE, so
    # reassigning study.train_set between runs rebuilds instead of silently
    # serving the previous dataset.
    cached = study.__dict__.get("_feature_dropping_cache")
    if cached is None or cached[0] is not src:
        cached = (src, feature_dropping_generator(src))
        study.__dict__["_feature_dropping_cache"] = cached
    return cached[1](ablated_feature=ablated_feature)
