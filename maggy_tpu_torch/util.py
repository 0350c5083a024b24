"""Framework utilities: the subset of ``maggy_tpu/util.py`` the driver and
executor call, with the run-id claims and the resume look-up
(``maggy_tpu/util.py:108-232``). Parity: reference `maggy/util.py` —
return-value validation + persistence `handle_return_val` (:151-191),
experiment registration (:264-279), numpy-safe json (:89-99), summary
builder (:126-148).
"""

from __future__ import annotations

import json
import os
import socket
import threading
import time
from typing import Any, Dict

import numpy as np

from maggy_tpu_torch import constants
from maggy_tpu_torch.exceptions import MetricTypeError, ReturnTypeError, RunAdoptionError


def json_default_numpy(obj):
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    raise TypeError("Type {} not serializable".format(type(obj)))


def json_dumps_safe(obj: Any) -> str:
    return json.dumps(obj, default=json_default_numpy)


def handle_return_val(return_val: Any, trial_dir: str, optimization_key: str,
                      env) -> float:
    """Validate the user function's return value and persist artifacts.

    Accepts a number (the metric) or a dict containing ``optimization_key``;
    writes ``.outputs.json`` + ``.metric`` into the trial dir."""
    if isinstance(return_val, dict):
        if optimization_key not in return_val:
            raise ReturnTypeError(optimization_key, return_val)
        metric = return_val[optimization_key]
        outputs = return_val
    elif isinstance(return_val, constants.USER_FCT.NUMERIC_TYPES) and not isinstance(return_val, bool):
        metric = return_val
        outputs = {optimization_key: return_val}
    else:
        raise ReturnTypeError(optimization_key, return_val)
    if not isinstance(metric, constants.USER_FCT.NUMERIC_TYPES) or isinstance(metric, bool):
        raise MetricTypeError(optimization_key, metric)
    metric = float(metric)
    env.dump(json.dumps(outputs, default=json_default_numpy), trial_dir + "/.outputs.json")
    env.dump(str(metric), trial_dir + "/.metric")
    return metric


def write_hparams_config(exp_dir: str, searchspace, env) -> None:
    """Persist the searchspace next to the experiment's results, and the
    TensorBoard HParams dashboard's column config (JAX ``util.py:64-77``;
    ``write_experiment_config`` swallows its own failures)."""
    if searchspace is None:
        return
    env.dump(json.dumps(searchspace.to_dict(), indent=2), exp_dir + "/searchspace.json")
    from maggy_tpu_torch import tensorboard

    tensorboard.write_experiment_config(exp_dir, searchspace)


def build_summary(exp_dir: str, env) -> Dict[str, Any]:
    """Aggregate every trial dir's .hparams.json/.outputs.json into one
    summary (reference `util.py:126-148`)."""
    combos = []
    for entry in env.ls(exp_dir):
        tdir = os.path.join(exp_dir, entry)
        hparams_p, outputs_p = tdir + "/.hparams.json", tdir + "/.outputs.json"
        if env.isdir(tdir) and env.exists(outputs_p):
            combo = {"id": entry}
            if env.exists(hparams_p):
                combo["hparams"] = json.loads(env.load(hparams_p))
            combo["outputs"] = json.loads(env.load(outputs_p))
            combos.append(combo)
    summary = {"combinations": combos, "built_at": time.time()}
    env.dump(json.dumps(summary, indent=2, default=json_default_numpy),
             exp_dir + "/.summary.json")
    return summary


def next_run_id(base_dir: str, app_id: str, env) -> int:
    """The first free run id of ``app_id`` under ``base_dir``. A scan only,
    racy by construction: starters claim through ``claim_run_id``; resume
    reads it to find the most recent existing run."""
    i = 0
    while env.exists("{}/{}_{}".format(base_dir.rstrip("/"), app_id, i)):
        i += 1
    return i


def find_resume_run_id(base_dir: str, app_id: str, name: str, env) -> int:
    """The run id ``resume=True`` re-enters: the most recent run of this app
    whose registered experiment ``name`` matches (one app id may host more
    than one experiment). A run whose experiment.json is missing or torn is
    skipped, never adopted blind. Raises ``ValueError`` when no run
    matches."""
    base = base_dir.rstrip("/")
    last = next_run_id(base, app_id, env) - 1
    for i in range(last, -1, -1):
        meta_path = "{}/{}_{}/experiment.json".format(base, app_id, i)
        if not env.exists(meta_path):
            continue
        try:
            meta = json.loads(env.load(meta_path))
        except ValueError:
            continue
        if meta.get("name") == name:
            return i
    raise ValueError(
        "resume=True but no previous run of app '{}' named '{}' exists "
        "under {} ({} run dir(s) scanned)".format(app_id, name, base, last + 1))


def claim_run_id(base_dir: str, app_id: str, env) -> int:
    """Atomically claim the next free run id under ``base_dir``: scan for
    the first free ``<app_id>_<i>`` and stake it with
    ``env.exclusive_create``, so two concurrent starters never mint the same
    id; a loser moves on to the next."""
    base = base_dir.rstrip("/")
    i = next_run_id(base, app_id, env)
    while True:
        run_dir = "{}/{}_{}".format(base, app_id, i)
        if not env.exists(run_dir):
            payload = json.dumps({"claimed_at": time.time(), "pid": os.getpid(),
                                  "thread": threading.get_ident()})
            if env.exclusive_create(payload, run_dir + "/.run_claim"):
                return i
        i += 1


#: Prefix of the per-incarnation adoption markers a driver stakes inside its
#: run dir (see claim_driver_epoch).
DRIVER_EPOCH_PREFIX = ".driver_epoch."


def claim_driver_epoch(run_dir: str, env) -> int:
    """Atomically claim the next driver incarnation of ``run_dir``
    (1-based): scan for the highest existing ``.driver_epoch.N`` and stake
    N+1 with ``env.exclusive_create``. Exactly one of two drivers resuming
    the same run wins each epoch; the loser gets ``RunAdoptionError``. A
    fresh run claims epoch 1 (its dir was staked by ``claim_run_id``). A
    predecessor that claimed earlier and never exited is caught instead by
    the rebind of its port (``Driver.__init__``)."""
    run_dir = run_dir.rstrip("/")
    epoch = 1
    while env.exists("{}/{}{}".format(run_dir, DRIVER_EPOCH_PREFIX, epoch)):
        epoch += 1
    payload = json.dumps({"claimed_at": time.time(), "pid": os.getpid(),
                          "thread": threading.get_ident()})
    marker = "{}/{}{}".format(run_dir, DRIVER_EPOCH_PREFIX, epoch)
    if not env.exclusive_create(payload, marker):
        raise RunAdoptionError(
            "run dir {} was adopted by another driver (incarnation marker {} already "
            "claimed); exactly one restarted driver may adopt a run — this one must "
            "exit".format(run_dir, marker.rsplit("/", 1)[-1]))
    return epoch


def host_address() -> str:
    """This host's address, for a ticket whose listener binds a wildcard."""
    try:
        return socket.gethostbyname(socket.gethostname())
    except OSError:
        return "127.0.0.1"


def address_toward(addr) -> str:
    """The local address this host reaches ``addr`` (host, port) from: a
    datagram socket's connect picks the route and sends nothing."""
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        try:
            s.connect((addr[0], int(addr[1])))
            return s.getsockname()[0]
        except OSError:
            return host_address()
