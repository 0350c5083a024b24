"""Named, versioned dataset registry: the feature store's surface.

Copy of ``maggy_tpu/train/registry.py`` (the reference resolves datasets
and their schemas through the Hopsworks feature store; LOCO reads dataset
schemas from it, reference ``maggy/ablation/ablator/loco.py:41-80``): JSON
manifests ``<root>/<name>/v<version>.json`` written through the active
environment's fs ops, the same files as the JAX package's, so either
package reads a registry the other wrote.

A manifest records ``{name, version, path, format, schema, description,
created}``. Consumers address datasets as ``registry://name`` (latest) or
``registry://name@<version>`` anywhere a dataset path is accepted
(``ShardedBatchIterator.from_path``, ``AblationStudy(train_set=...)``,
``train.data.load_path_dataset``). Nothing of the registry is cut: on a
``GCSEnv`` the manifests live in the bucket and the data paths stay where
the data lives.
"""

from __future__ import annotations

import datetime
import json
import os
from typing import Any, Dict, List, Optional

REGISTRY_SCHEME = "registry://"

#: Overrides the default registry root (``<env base dir>/datasets``) for
#: every consumer that does not pass an explicit root — the data loaders'
#: ``registry://`` resolution and LOCO's registry probe included. Makes
#: custom-root registries URI-addressable without threading a root through
#: each call site.
REGISTRY_ROOT_ENV_VAR = "MAGGY_TPU_REGISTRY_ROOT"


def _env():
    from maggy_tpu_torch.core.environment import EnvSing

    return EnvSing.get_instance()


class DatasetRegistry:
    """Register and resolve named dataset versions.

    ``root`` defaults to $MAGGY_TPU_REGISTRY_ROOT, else ``<environment
    base dir>/datasets``. All IO goes through the environment (atomic
    dumps, exclusive creates).
    """

    def __init__(self, env=None, root: Optional[str] = None):
        self.env = env or _env()
        self.root = (root or os.environ.get(REGISTRY_ROOT_ENV_VAR)
                     or self.env.experiment_base_dir() + "/datasets")

    # ------------------------------------------------------------- manifest
    def _dir(self, name: str) -> str:
        if not name or "/" in name or "@" in name:
            raise ValueError("Dataset names must be non-empty and contain "
                             "no '/' or '@': {!r}".format(name))
        return "{}/{}".format(self.root, name)

    def _manifest_path(self, name: str, version: int) -> str:
        return "{}/v{}.json".format(self._dir(name), int(version))

    def register(
        self,
        name: str,
        path: str,
        version: Optional[int] = None,
        schema: Optional[Dict[str, str]] = None,
        description: str = "",
    ) -> int:
        """Record a dataset version; returns the version number.

        ``version=None`` auto-increments past the latest. ``schema=None``
        infers column names/dtypes from the data (loads the source once —
        fine for sweep-sized sets; pass an explicit schema for huge ones).
        Re-registering an existing (name, version) raises: versions are
        immutable, append a new one instead.
        """
        if version is None:
            existing = self.versions(name)
            version = (existing[-1] + 1) if existing else 1
        mpath = self._manifest_path(name, version)
        if self.env.exists(mpath):
            raise ValueError(
                "{}@{} already registered; versions are immutable — "
                "register a new version instead.".format(name, version))
        if schema is None:
            schema = infer_schema(path)
        manifest = {
            "name": name,
            "version": int(version),
            "path": path,
            "format": _format_of(path),
            "schema": schema,
            "description": description,
            "created": datetime.datetime.now(
                datetime.timezone.utc).isoformat(),
        }
        self.env.mkdir(self._dir(name))
        payload = json.dumps(manifest, indent=2)
        # Concurrent registrations of the same name can race the
        # exists()-then-dump window and pick the same auto-version;
        # exclusive_create (O_CREAT|O_EXCL) makes exactly one writer win
        # and every loser fail loudly, never a silent last-writer-wins.
        if not self.env.exclusive_create(payload, mpath):
            raise ValueError(
                "{}@{} was registered concurrently by another writer; "
                "retry to get a fresh version number.".format(name, version))
        return int(version)

    # -------------------------------------------------------------- lookup
    def names(self) -> List[str]:
        if not self.env.exists(self.root):
            return []
        return sorted(n for n in self.env.ls(self.root)
                      if self.env.isdir("{}/{}".format(self.root, n)))

    def versions(self, name: str) -> List[int]:
        d = self._dir(name)
        if not self.env.exists(d):
            return []
        out = []
        for f in self.env.ls(d):
            if f.startswith("v") and f.endswith(".json"):
                try:
                    out.append(int(f[1:-5]))
                except ValueError:
                    continue
        return sorted(out)

    def get(self, name: str, version: Optional[int] = None) -> Dict[str, Any]:
        """The manifest dict for ``name`` (latest version by default)."""
        if version is None:
            vs = self.versions(name)
            if not vs:
                raise KeyError("No dataset {!r} in the registry at {} "
                               "(known: {})".format(
                                   name, self.root, self.names()))
            version = vs[-1]
        mpath = self._manifest_path(name, version)
        if not self.env.exists(mpath):
            raise KeyError("No version {} of dataset {!r} (have: {})".format(
                version, name, self.versions(name)))
        return json.loads(self.env.load(mpath))

    def path(self, name: str, version: Optional[int] = None) -> str:
        return self.get(name, version)["path"]

    def schema(self, name: str, version: Optional[int] = None) -> Dict[str, str]:
        return self.get(name, version)["schema"]

    def features(self, name: str, version: Optional[int] = None) -> List[str]:
        """Column names — what LOCO ablates over (the reference reads these
        from the feature-store schema, ref `loco.py:41-80`)."""
        return sorted(self.schema(name, version))

    # ------------------------------------------------------------------ uri
    def resolve(self, uri: str) -> Dict[str, Any]:
        """``registry://name`` or ``registry://name@<version>`` -> manifest."""
        name, version = parse_uri(uri)
        return self.get(name, version)


def parse_uri(uri: str):
    if not uri.startswith(REGISTRY_SCHEME):
        raise ValueError("Not a registry URI: {!r}".format(uri))
    ref = uri[len(REGISTRY_SCHEME):]
    if "@" in ref:
        name, _, v = ref.partition("@")
        try:
            return name, int(v)
        except ValueError:
            raise ValueError("Bad registry version in {!r} (want "
                             "registry://name@<int>)".format(uri)) from None
    return ref, None


def is_registry_uri(path: Any) -> bool:
    return isinstance(path, str) and path.startswith(REGISTRY_SCHEME)


def resolve_path(uri: str, env=None, root: Optional[str] = None) -> str:
    """Registry URI -> concrete dataset path (module-level convenience for
    the data loaders). ``root`` (or $MAGGY_TPU_REGISTRY_ROOT) addresses a
    registry living outside the default ``<base dir>/datasets`` root."""
    return DatasetRegistry(env=env, root=root).resolve(uri)["path"]


def _format_of(path: str) -> str:
    from maggy_tpu_torch.train import tfrecord as _tfr

    if _tfr.is_tfrecord_path(path):
        return "tfrecord"
    if path.endswith(".npz"):
        return "npz"
    return "parquet"


def infer_schema(path: str) -> Dict[str, str]:
    """Column -> dtype string, read from the data itself."""
    from maggy_tpu_torch.train.data import load_path_dataset

    data = load_path_dataset(path)
    return {k: str(v.dtype) for k, v in data.items()}
