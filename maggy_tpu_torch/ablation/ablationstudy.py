"""User-facing ablation-study specification.

Copy of ``maggy_tpu/ablation/ablationstudy.py`` (parity: reference
`maggy/ablation/ablationstudy.py` — dataset spec + optional custom dataset
generator (:109-128,151-157), `Features` include/exclude set (:160-225),
`Model` with base/custom model generators (:228-250), `Layers` include/
exclude single layers, layer groups as frozensets, prefix groups
(:253-408), `to_dict` (:130-149)). Trials carry declarative ablation specs
(``{"ablated_feature": ..., "ablated_layer": ...}``), which the trial
executor resolves back through this study object. Nothing is cut; model
surgery targets ``torch.nn`` modules through ``models/surgery.py``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, FrozenSet, List, Optional, Set


class Features:
    """Set of input features eligible for leave-one-out ablation."""

    def __init__(self):
        self.included_features: Set[str] = set()

    def include(self, *features: str) -> None:
        for f in self._flatten(features):
            if not isinstance(f, str):
                raise ValueError("Feature names must be strings, got {!r}".format(f))
            self.included_features.add(f)

    def exclude(self, *features: str) -> None:
        for f in self._flatten(features):
            self.included_features.discard(f)

    @staticmethod
    def _flatten(features):
        out = []
        for f in features:
            if isinstance(f, (list, tuple, set)):
                out.extend(f)
            else:
                out.append(f)
        return out

    def list_all(self) -> List[str]:
        return sorted(self.included_features)


class Layers:
    """Model components eligible for ablation: single layers, explicit
    groups, and prefix groups (all by layer NAME within the user's model)."""

    def __init__(self):
        self.included_layers: Set[str] = set()
        self.included_groups: Set[FrozenSet[str]] = set()

    def include(self, *layers: str) -> None:
        for l in Features._flatten(layers):
            if not isinstance(l, str):
                raise ValueError("Layer names must be strings, got {!r}".format(l))
            self.included_layers.add(l)

    def exclude(self, *layers: str) -> None:
        for l in Features._flatten(layers):
            self.included_layers.discard(l)

    def include_groups(self, *groups, prefix: Optional[str] = None) -> None:
        """Add layer groups ablated together; a prefix group ablates every
        layer whose name starts with ``prefix`` (reference
        `ablationstudy.py:300-360`)."""
        if prefix is not None:
            if not isinstance(prefix, str):
                raise ValueError("prefix must be a string")
            self.included_groups.add(frozenset([prefix]))
        for g in groups:
            if not isinstance(g, (list, set, tuple)) or len(g) < 2:
                raise ValueError(
                    "A layer group must be a list/set of >= 2 layer names; "
                    "use include() for single layers or prefix= for prefixes."
                )
            self.included_groups.add(frozenset(g))

    def exclude_groups(self, *groups, prefix: Optional[str] = None) -> None:
        if prefix is not None:
            self.included_groups.discard(frozenset([prefix]))
        for g in groups:
            self.included_groups.discard(frozenset(g))

    def list_all(self) -> List[Any]:
        singles = sorted(self.included_layers)
        groups = sorted(sorted(g) for g in self.included_groups)
        return singles + groups


class Model:
    """The model side of the study: a base generator plus named custom
    variants. Generators are looked up by name at execution time, so trials
    stay declarative."""

    def __init__(self):
        self.base_model_generator: Optional[Callable] = None
        self.custom_model_generators: Dict[str, Callable] = {}
        self.layers = Layers()

    def set_base_model_generator(self, generator: Callable) -> None:
        if not callable(generator):
            raise ValueError("base_model_generator must be callable")
        self.base_model_generator = generator

    def add_custom_model_generator(self, name: str, generator: Callable) -> None:
        if not callable(generator):
            raise ValueError("custom model generator must be callable")
        self.custom_model_generators[name] = generator


class AblationStudy:
    """Declarative spec of a leave-one-component-out study.

    ``dataset_generator(ablated_feature=None)`` must return the training
    data minus the ablated feature; ``model.base_model_generator
    (ablated_layers=frozenset())`` must return the model minus the ablated
    layers (``maggy_tpu_torch.models.surgery`` builds one from named layer
    factories).
    """

    def __init__(
        self,
        training_dataset_name: str = "",
        training_dataset_version: int = 1,
        label_name: str = "",
        dataset_generator: Optional[Callable] = None,
        train_set: Any = None,
    ):
        self.name = training_dataset_name
        self.version = training_dataset_version
        self.label_name = label_name
        self.custom_dataset_generator = dataset_generator
        #: Built-in feature dropping (the local analogue of the reference's
        #: feature-store read, `loco.py:41-80`): a dict of arrays or a path
        #: ``train.data.load_path_dataset`` reads. When set and no custom
        #: generator is given, each trial's dataset_function returns this
        #: data minus the ablated feature.
        self.train_set = train_set
        self.features = Features()
        self.model = Model()

    def to_dict(self) -> Dict[str, Any]:
        return {
            "training_dataset_name": self.name,
            "training_dataset_version": self.version,
            "label_name": self.label_name,
            "included_features": self.features.list_all(),
            "included_layers": self.model.layers.list_all(),
            "custom_models": sorted(self.model.custom_model_generators),
            "has_custom_dataset_generator": self.custom_dataset_generator is not None,
        }
