"""Framework utilities: the subset of ``maggy_tpu/util.py`` the driver and
executor call. Parity: reference `maggy/util.py` — return-value validation
+ persistence `handle_return_val` (:151-191), experiment registration
(:264-279), numpy-safe json (:89-99), summary builder (:126-148).
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict

import numpy as np

from maggy_tpu_torch import constants
from maggy_tpu_torch.exceptions import MetricTypeError, ReturnTypeError


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
    """Persist the searchspace next to the experiment's results."""
    if searchspace is not None:
        env.dump(json.dumps(searchspace.to_dict(), indent=2), exp_dir + "/searchspace.json")


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


def claim_run_id(base_dir: str, app_id: str, env) -> int:
    """Atomically claim the next free run id under ``base_dir``: scan for
    the first free ``<app_id>_<i>`` and stake it with
    ``env.exclusive_create``, so two concurrent starters never mint the same
    id; a loser moves on to the next."""
    base = base_dir.rstrip("/")
    i = 0
    while True:
        run_dir = "{}/{}_{}".format(base, app_id, i)
        if not env.exists(run_dir):
            payload = json.dumps({"claimed_at": time.time(), "pid": os.getpid(),
                                  "thread": threading.get_ident()})
            if env.exclusive_create(payload, run_dir + "/.run_claim"):
                return i
        i += 1
