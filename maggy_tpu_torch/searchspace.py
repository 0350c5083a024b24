"""Typed hyperparameter search space with a unit-cube normalization codec.

Copy of ``maggy_tpu/searchspace.py`` without the GANG type (multi-chip
trial shapes need the gang scheduler, which the port does not have yet).

Parity: reference `maggy/searchspace.py` (types at :60-63, validation at
:71-150, sampling at :180-208, container protocol at :210-264, transform codec
at :266-443, dict/list converters at :445-479). Re-designed, not translated:

- sampling uses an explicit seedable ``numpy.random.Generator`` (the reference
  uses the global numpy RNG, which makes experiments unreproducible),
- the codec vectorizes over trial batches so Bayesian-optimization surrogates
  can encode/decode entire observation matrices at once.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Iterator, List, Sequence, Tuple

import numpy as np

# Reserved names injected by the framework into trial parameter dicts.
RESERVED_NAMES = ("budget", "ablated_feature", "ablated_layer", "dataset_function", "model_function")


class Searchspace:
    """A collection of typed hyperparameters.

    Supported types (reference `searchspace.py:60-63`):

    - ``DOUBLE``: continuous, ``(low, high)`` with ``low < high``
    - ``DOUBLE_LOG``: continuous sampled/encoded log-uniformly, ``(low,
      high)`` with ``0 < low < high`` — the right prior for scale
      hyperparameters (learning rate, weight decay); a TPU-build extension
      beyond the reference's four types (`searchspace.py:60-63`)
    - ``INTEGER``: integer range, ``(low, high)`` inclusive with ``low < high``
    - ``DISCRETE``: explicit list of numeric values
    - ``CATEGORICAL``: explicit list of string values

    Construct with kwargs or :meth:`add`::

        sp = Searchspace(lr=("DOUBLE", [1e-5, 1e-1]), layers=("INTEGER", [1, 8]))
        sp.add("activation", ("CATEGORICAL", ["relu", "gelu"]))
    """

    DOUBLE = "DOUBLE"
    DOUBLE_LOG = "DOUBLE_LOG"
    INTEGER = "INTEGER"
    DISCRETE = "DISCRETE"
    CATEGORICAL = "CATEGORICAL"

    _TYPES = (DOUBLE, DOUBLE_LOG, INTEGER, DISCRETE, CATEGORICAL)
    # Continuous kinds (shared by optimizers for guards/perturbations).
    CONTINUOUS_TYPES = (DOUBLE, DOUBLE_LOG, INTEGER)

    def __init__(self, **kwargs):
        self._hparam_types: Dict[str, str] = {}
        self._hparams: Dict[str, list] = {}
        for name, value in kwargs.items():
            self.add(name, value)

    # ------------------------------------------------------------------ build

    def add(self, name: str, value: Sequence) -> None:
        """Add one hyperparameter; validates like reference `searchspace.py:96-150`."""
        if not isinstance(name, str):
            raise ValueError("Hyperparameter name must be a string, got {}.".format(type(name)))
        if name in RESERVED_NAMES:
            raise ValueError(
                "'{}' is a reserved parameter name (reserved: {}).".format(name, RESERVED_NAMES)
            )
        if name in self._hparam_types:
            raise ValueError("Hyperparameter '{}' already exists.".format(name))
        if not isinstance(value, (tuple, list)) or len(value) != 2:
            raise ValueError(
                "Hyperparameter '{}' must be a (type, feasible_region) pair, got {!r}.".format(
                    name, value
                )
            )
        hp_type, region = value[0], value[1]
        if not isinstance(hp_type, str) or hp_type.upper() not in self._TYPES:
            raise ValueError(
                "Hyperparameter type for '{}' must be one of {}, got {!r}.".format(
                    name, self._TYPES, hp_type
                )
            )
        hp_type = hp_type.upper()
        if not isinstance(region, (tuple, list)) or len(region) == 0:
            raise ValueError(
                "Feasible region of '{}' must be a non-empty list, got {!r}.".format(name, region)
            )
        region = list(region)

        if hp_type == Searchspace.DOUBLE:
            self._validate_bounds(name, region, (int, float), "DOUBLE")
        elif hp_type == Searchspace.DOUBLE_LOG:
            self._validate_bounds(name, region, (int, float), "DOUBLE_LOG")
            if region[0] <= 0:
                raise ValueError(
                    "DOUBLE_LOG bounds of '{}' must be positive, got {!r}.".format(name, region))
        elif hp_type == Searchspace.INTEGER:
            self._validate_bounds(name, region, (int,), "INTEGER")
        elif hp_type == Searchspace.DISCRETE:
            for v in region:
                if not isinstance(v, (int, float)):
                    raise ValueError(
                        "DISCRETE values of '{}' must be numeric, got {!r}.".format(name, v)
                    )
        elif hp_type == Searchspace.CATEGORICAL:
            for v in region:
                if not isinstance(v, str):
                    raise ValueError(
                        "CATEGORICAL values of '{}' must be strings, got {!r}.".format(name, v)
                    )
        self._hparam_types[name] = hp_type
        self._hparams[name] = region

    @staticmethod
    def _validate_bounds(name, region, scalar_types, label):
        if len(region) != 2:
            raise ValueError(
                "{} '{}' requires [low, high] bounds, got {!r}.".format(label, name, region)
            )
        low, high = region
        for v in (low, high):
            if not isinstance(v, scalar_types) or isinstance(v, bool):
                raise ValueError(
                    "{} bounds of '{}' must be {}, got {!r}.".format(label, name, scalar_types, v)
                )
        if low >= high:
            raise ValueError(
                "{} '{}' lower bound {} must be < upper bound {}.".format(label, name, low, high)
            )

    # --------------------------------------------------------------- protocol

    def names(self) -> List[str]:
        return list(self._hparam_types)

    def get(self, name: str, default=None):
        return self._hparams.get(name, default)

    def get_type(self, name: str) -> str:
        return self._hparam_types[name]

    def keys(self):
        return self._hparams.keys()

    def values(self):
        return self._hparams.values()

    def items(self) -> Iterator[Dict[str, Any]]:
        """Yield dicts of (name, type, values) like reference `searchspace.py:240-253`."""
        for name in self._hparams:
            yield {"name": name, "type": self._hparam_types[name], "values": self._hparams[name]}

    def __contains__(self, name) -> bool:
        return name in self._hparam_types

    def __len__(self) -> int:
        return len(self._hparam_types)

    def __iter__(self):
        return iter(self.items())

    def __getitem__(self, name):
        return self._hparams[name]

    def __str__(self):
        return json.dumps(self.to_dict(), indent=None)

    def to_dict(self) -> Dict[str, Any]:
        return {
            name: {"type": self._hparam_types[name], "values": self._hparams[name]}
            for name in self._hparams
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Searchspace":
        sp = cls()
        for name, spec in d.items():
            sp.add(name, (spec["type"], spec["values"]))
        return sp

    # --------------------------------------------------------------- sampling

    def get_random_parameter_values(
        self, num: int, rng: np.random.Generator | None = None
    ) -> List[Dict[str, Any]]:
        """Draw ``num`` iid parameter dicts (reference `searchspace.py:180-208`)."""
        rng = rng if rng is not None else np.random.default_rng()
        out = []
        for _ in range(num):
            params = {}
            for name, hp_type in self._hparam_types.items():
                region = self._hparams[name]
                if hp_type == Searchspace.DOUBLE:
                    params[name] = float(rng.uniform(region[0], region[1]))
                elif hp_type == Searchspace.DOUBLE_LOG:
                    params[name] = float(np.exp(rng.uniform(
                        np.log(region[0]), np.log(region[1]))))
                elif hp_type == Searchspace.INTEGER:
                    params[name] = int(rng.integers(region[0], region[1] + 1))
                else:  # DISCRETE / CATEGORICAL
                    params[name] = region[int(rng.integers(0, len(region)))]
            out.append(params)
        return out

    def grid(self) -> List[Dict[str, Any]]:
        """Cartesian product over DISCRETE/CATEGORICAL axes (reference
        `gridsearch.py:72-79`). Raises on continuous axes."""
        import itertools

        axes = []
        for name, hp_type in self._hparam_types.items():
            if hp_type in Searchspace.CONTINUOUS_TYPES:
                raise ValueError(
                    "Grid search requires DISCRETE/CATEGORICAL parameters only; "
                    "'{}' is {}.".format(name, hp_type)
                )
            axes.append([(name, v) for v in self._hparams[name]])
        return [dict(combo) for combo in itertools.product(*axes)]

    # ------------------------------------------------------------------ codec
    #
    # Normalization codec used by BO surrogates: every hyperparameter maps to
    # [0, 1]. DOUBLE/INTEGER min-max normalize; DISCRETE/CATEGORICAL index-
    # encode then normalize by cardinality (reference `searchspace.py:266-443`,
    # vectorized here).

    def encode_continuous(self, name: str, v) -> float:
        """One continuous value -> [0, 1] (the single source of truth for
        the per-type scalar codec; TPE's surrogate encoding reuses it)."""
        hp_type, region = self._hparam_types[name], self._hparams[name]
        if hp_type == Searchspace.DOUBLE:
            return (float(v) - region[0]) / (region[1] - region[0])
        if hp_type == Searchspace.DOUBLE_LOG:
            lo, hi = np.log(region[0]), np.log(region[1])
            return float((np.log(float(v)) - lo) / (hi - lo))
        if hp_type == Searchspace.INTEGER:
            # map integers to bin centers so inverse rounding is stable
            return (float(v) - region[0] + 0.5) / (region[1] - region[0] + 1)
        raise ValueError("'{}' is not a continuous hyperparameter.".format(name))

    def decode_continuous(self, name: str, x: float):
        """[0, 1] -> a continuous value (inverse of encode_continuous)."""
        hp_type, region = self._hparam_types[name], self._hparams[name]
        x = float(np.clip(x, 0.0, 1.0))
        if hp_type == Searchspace.DOUBLE:
            return float(region[0] + x * (region[1] - region[0]))
        if hp_type == Searchspace.DOUBLE_LOG:
            lo, hi = np.log(region[0]), np.log(region[1])
            return float(np.exp(lo + x * (hi - lo)))
        if hp_type == Searchspace.INTEGER:
            n = region[1] - region[0] + 1
            return int(min(region[1], region[0] + int(x * n)))
        raise ValueError("'{}' is not a continuous hyperparameter.".format(name))

    def transform(self, params: Dict[str, Any]) -> np.ndarray:
        """Encode one parameter dict to a point in the unit hypercube."""
        x = np.empty(len(self._hparam_types), dtype=np.float64)
        for i, (name, hp_type) in enumerate(self._hparam_types.items()):
            if hp_type in Searchspace.CONTINUOUS_TYPES:
                x[i] = self.encode_continuous(name, params[name])
            else:
                region = self._hparams[name]
                idx = region.index(params[name])
                x[i] = (idx + 0.5) / len(region)
        return x

    def inverse_transform(self, x: np.ndarray) -> Dict[str, Any]:
        """Decode a unit-hypercube point back to a parameter dict."""
        x = np.clip(np.asarray(x, dtype=np.float64), 0.0, 1.0)
        params: Dict[str, Any] = {}
        for i, (name, hp_type) in enumerate(self._hparam_types.items()):
            if hp_type in Searchspace.CONTINUOUS_TYPES:
                params[name] = self.decode_continuous(name, x[i])
            else:
                region = self._hparams[name]
                n = len(region)
                params[name] = region[min(n - 1, int(x[i] * n))]
        return params

    def transform_batch(self, params_list: Sequence[Dict[str, Any]]) -> np.ndarray:
        """Encode a list of parameter dicts into an (N, D) matrix."""
        if not params_list:
            return np.zeros((0, len(self._hparam_types)))
        return np.stack([self.transform(p) for p in params_list])

    def inverse_transform_batch(self, X: np.ndarray) -> List[Dict[str, Any]]:
        return [self.inverse_transform(row) for row in np.atleast_2d(X)]

    def var_types(self) -> List[str]:
        """Per-dimension kind for surrogates: 'c' continuous / 'u' unordered
        (reference TPE var_type construction, `tpe.py:180-189`)."""
        out = []
        for hp_type in self._hparam_types.values():
            out.append("c" if hp_type in Searchspace.CONTINUOUS_TYPES else "u")
        return out

    @staticmethod
    def dict_to_list(params: Dict[str, Any], names: Sequence[str]) -> List[Any]:
        return [params[n] for n in names]

    @staticmethod
    def list_to_dict(values: Sequence[Any], names: Sequence[str]) -> Dict[str, Any]:
        if len(values) != len(names):
            raise ValueError("Length mismatch between values and names.")
        return dict(zip(names, values))
