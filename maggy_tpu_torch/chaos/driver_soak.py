"""Chaos invariant 13: SIGKILL the driver mid-sweep, restart, recover.

The port's copy of ``maggy_tpu/chaos/driver_soak.py``, with real processes:

1. a driver process (``python -m maggy_tpu_torch.chaos.driver_soak
   --child``) runs a seeded remote-pool sweep with an fsync-armed journal;
2. runner agents (``python -m maggy_tpu_torch.runner``) join over the
   socket and survive the driver (MAGGY_TPU_CLIENT_MAX_RETRIES raises their
   retry horizon past the restart window);
3. once the journal shows progress, the harness SIGKILLs the driver and
   appends the ``kill_driver`` chaos record to the quiesced journal (the
   fault kills the process that owns the chaos engine, so no in-process
   plan can record it);
4. a new driver child restarts with ``resume=True``: it adopts the run dir
   (``.driver_epoch.N``), comes back on the same secret and port, replays
   the journal, adopts the surviving runners and finishes the sweep;
5. the harness replays the final journal through ``check_invariants``:
   invariant 13 (no trial lost, no duplicate FINAL, completed trials never
   re-run, every kill followed by a recovered incarnation) and the rest.

``python -m maggy_tpu_torch.chaos --driver`` runs it. The trials are
closed-form host work, and every child runs with no card visible. With
``lock_witness`` (the default) each driver child runs under the lock-order
witness (``MAGGY_TPU_TORCH_LOCK_WITNESS=1`` in its environment) and dumps
its snapshot beside the base dir; the parent sums the children's edges and
violations into the report's ``witness`` block (zero edges is a violation:
the race check ran nothing).
"""

from __future__ import annotations

import glob
import json
import os
import signal
import subprocess
import sys
import time
from typing import Any, Dict, List, Optional

#: The soak's fixed app id: resume must find the same run dir across
#: driver incarnations (MAGGY_TPU_APP_ID pins it for the children).
APP_ID = "driversoak"

#: Seconds a surviving runner keeps retrying a dead control plane — must
#: cover driver restart (spawn + imports + replay). 20 retries at the
#: 2 s backoff cap is ~35 s.
CHILD_CLIENT_RETRIES = 20


def failover_train_fn(lr, units, reporter=None):
    """Module-level (agents import it by dotted path) paced trial:
    ~3-4 s of heartbeating steps so a driver kill lands mid-trial and the
    surviving runner's FINAL arrives AFTER the restart — the retried-
    FINAL-across-incarnations path the soak exists to exercise."""
    import time as _time

    acc = 1.0 - ((lr - 0.1) ** 2 + ((units - 32) / 64.0) ** 2)
    for step in range(24):
        _time.sleep(0.15)
        if reporter is not None:
            reporter.broadcast(acc * (step + 1) / 24.0, step=step)
    return {"metric": acc}


# ---------------------------------------------------------------- children


def child_main(argv: Optional[List[str]] = None) -> int:
    """One driver incarnation (``--child``): run the soak's sweep over a
    remote runner pool; with ``--resume``, adopt and recover the
    interrupted run. Dumps a lock-order witness snapshot next to the base
    dir when the environment arms the witness, for the parent to sum."""
    import argparse

    ap = argparse.ArgumentParser(prog="python -m maggy_tpu_torch.chaos.driver_soak")
    ap.add_argument("--child", action="store_true", required=True)
    ap.add_argument("--base-dir", required=True)
    ap.add_argument("--trials", type=int, default=8)
    ap.add_argument("--workers", type=int, default=3)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--resume", action="store_true")
    # Above the runner-client's 2 s retry-backoff cap with margin: a
    # surviving runner's first post-restart contact must land inside the
    # recovered record's one liveness window, or a false loss would
    # requeue a live runner's trial (correct but adoption-less).
    ap.add_argument("--hb-loss-timeout", type=float, default=6.0)
    args = ap.parse_args(argv)

    # Witness first: locks constructed after install are wrapped.
    from maggy_tpu_torch.analysis import witness as _witness

    wit = _witness.install() if _witness.enabled_by_env() else None

    from maggy_tpu_torch import OptimizationConfig, Searchspace, experiment

    config = OptimizationConfig(
        name="driver_soak", num_trials=args.trials,
        optimizer="randomsearch",
        searchspace=Searchspace(lr=("DOUBLE", [0.0, 0.2]),
                                units=("INTEGER", [8, 64])),
        direction="max", num_workers=args.workers, pool="remote",
        hb_interval=0.25,
        hb_loss_timeout=args.hb_loss_timeout, seed=args.seed,
        es_policy="none", experiment_dir=args.base_dir,
        resume=args.resume)
    rc = 0
    try:
        result = experiment.lagom(failover_train_fn, config)
        print(json.dumps({"ok": True,
                          "num_trials": result.get("num_trials"),
                          "best_val": result.get("best_val")}), flush=True)
    except BaseException as e:  # noqa: BLE001 - the parent reads the verdict
        print(json.dumps({"ok": False, "error": repr(e)}), flush=True)
        rc = 1
    if wit is not None:
        snap = wit.snapshot()
        with open(os.path.join(args.base_dir,
                               "witness_{}.json".format(os.getpid())), "w") as f:
            json.dump({"edge_count": snap["edge_count"], "violations": snap["violations"],
                       "acquisitions": snap["acquisitions"], "busy_s": snap["busy_s"]}, f)
    return rc


# ----------------------------------------------------------------- harness


def _child_env(lock_witness: bool) -> Dict[str, str]:
    env = dict(os.environ)
    env["MAGGY_TPU_APP_ID"] = APP_ID
    env["MAGGY_TPU_JOURNAL_FSYNC"] = "1"
    env["MAGGY_TPU_CLIENT_MAX_RETRIES"] = str(CHILD_CLIENT_RETRIES)
    if lock_witness:
        env["MAGGY_TPU_TORCH_LOCK_WITNESS"] = "1"
    else:
        env.pop("MAGGY_TPU_TORCH_LOCK_WITNESS", None)
    # The closed-form trials need no card: the children never touch CUDA.
    env["CUDA_VISIBLE_DEVICES"] = ""
    # The children import this package from where this process did.
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    return env


def _spawn_driver(base_dir: str, trials: int, workers: int, seed: int,
                  resume: bool, env: Dict[str, str]) -> subprocess.Popen:
    argv = [sys.executable, "-m", "maggy_tpu_torch.chaos.driver_soak", "--child",
            "--base-dir", base_dir, "--trials", str(trials),
            "--workers", str(workers), "--seed", str(seed)]
    if resume:
        argv.append("--resume")
    return subprocess.Popen(argv, env=env,
                            stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT)


def _spawn_runner(ticket: str, env: Dict[str, str]) -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, "-m", "maggy_tpu_torch.runner", "--ticket", ticket,
         "--wait-ticket", "120",
         "--train", "maggy_tpu_torch.chaos.driver_soak:failover_train_fn"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)


def _journal_path(base_dir: str) -> str:
    from maggy_tpu_torch.telemetry import JOURNAL_NAME

    return os.path.join(base_dir, "{}_0".format(APP_ID), JOURNAL_NAME)


def _finalized_count(journal: str) -> int:
    from maggy_tpu_torch.telemetry.journal import _parse_jsonl

    if not os.path.exists(journal):
        return 0
    try:
        with open(journal) as f:
            events = _parse_jsonl(f.read())
    except OSError:
        return 0
    return sum(1 for ev in events
               if ev.get("ev") == "trial" and ev.get("phase") == "finalized")


def _append_kill_record(journal: str, n_finalized: int) -> float:
    """Harness-injected fault record: the dead driver's journal is
    quiescent, so the parent appends the ``kill_driver`` chaos event
    directly. The leading newline starts a fresh line past any torn tail
    the killed flusher left (the parser skips the torn fragment, and the
    restarted driver's first full-rewrite flush repairs the file)."""
    t0 = time.time()
    record = {"t": t0, "ev": "chaos", "kind": "kill_driver",
              "injected_by": "harness", "finalized_at_kill": n_finalized}
    with open(journal, "a") as f:
        f.write("\n" + json.dumps(record) + "\n")
    return t0


def _drain(proc: subprocess.Popen) -> str:
    try:
        out = proc.stdout.read() if proc.stdout else b""
        return out.decode(errors="replace")
    except Exception:  # noqa: BLE001 - diagnostics only
        return ""


def run_driver_soak(trials: int = 6, workers: int = 3, seed: int = 7,
                    kills: int = 1, base_dir: Optional[str] = None,
                    lock_witness: bool = True,
                    progress_per_kill: int = 1,
                    restart_timeout_s: float = 240.0) -> Dict[str, Any]:
    """Run the kill_driver soak end to end; returns the invariant report
    (``check_invariants`` shape + ``failover``/``witness`` blocks)."""
    import tempfile

    from maggy_tpu_torch.chaos.harness import check_invariants
    from maggy_tpu_torch.telemetry import read_events

    base_dir = base_dir or tempfile.mkdtemp(prefix="maggy_driver_soak_")
    env = _child_env(lock_witness)
    journal = _journal_path(base_dir)
    ticket = os.path.join(base_dir, "{}_0".format(APP_ID),
                          "runner_ticket.json")
    runners: List[subprocess.Popen] = []
    driver: Optional[subprocess.Popen] = None
    kill_times: List[float] = []
    child_logs: List[str] = []
    try:
        driver = _spawn_driver(base_dir, trials, workers, seed,
                               resume=False, env=env)
        deadline = time.monotonic() + restart_timeout_s
        while not os.path.exists(ticket):
            if driver.poll() is not None:
                raise RuntimeError(
                    "driver child exited before publishing the runner "
                    "ticket:\n" + _drain(driver))
            if time.monotonic() > deadline:
                raise TimeoutError("no runner ticket after {}s".format(
                    restart_timeout_s))
            time.sleep(0.2)
        for _ in range(workers):
            runners.append(_spawn_runner(ticket, env))

        done = 0
        for k in range(kills):
            # Wait for fresh progress past the last kill, then SIGKILL
            # mid-sweep. If the sweep finishes first the soak verified
            # nothing — fail loudly below.
            want = done + progress_per_kill
            deadline = time.monotonic() + restart_timeout_s
            while _finalized_count(journal) < want:
                if driver.poll() is not None:
                    raise RuntimeError(
                        "driver child finished before kill {} — the soak "
                        "raced the schedule; raise trials or trial "
                        "length:\n{}".format(k + 1, _drain(driver)))
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        "no sweep progress before kill {} after "
                        "{}s".format(k + 1, restart_timeout_s))
                time.sleep(0.2)
            done = _finalized_count(journal)
            driver.send_signal(signal.SIGKILL)
            driver.wait(timeout=30)
            child_logs.append(_drain(driver))
            kill_times.append(_append_kill_record(journal, done))
            driver = _spawn_driver(base_dir, trials, workers, seed,
                                   resume=True, env=env)

        out, _ = driver.communicate(timeout=restart_timeout_s)
        child_logs.append(out.decode(errors="replace") if out else "")
        final_rc = driver.returncode
        driver = None
        # Runner agents observe GSTOP and exit on their own.
        for proc in runners:
            try:
                proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
    finally:
        for proc in ([driver] if driver is not None else []) + runners:
            if proc.poll() is None:
                proc.kill()

    events = read_events(journal)
    report = check_invariants(events)
    if final_rc != 0:
        report["violations"].append(
            "recovered driver exited non-zero ({}): {}".format(
                final_rc, (child_logs[-1] or "")[-2000:]))
    if report["failover"]["kills"] != kills:
        report["violations"].append(
            "kill accounting: {} kill_driver record(s) journaled for {} "
            "kill(s)".format(report["failover"]["kills"], kills))
    if len(report["failover"]["driver_epochs"]) < kills + 1:
        report["violations"].append(
            "missing incarnations: {} driver_epoch event(s) for {} "
            "kill(s)".format(len(report["failover"]["driver_epochs"]),
                             kills))
    # Witness aggregation across the incarnations.
    if lock_witness:
        block = {"edge_count": 0, "violations": [], "acquisitions": 0, "busy_s": 0.0}
        for path in sorted(glob.glob(os.path.join(base_dir, "witness_*.json"))):
            with open(path) as f:
                snap = json.load(f)
            block["edge_count"] += int(snap.get("edge_count") or 0)
            block["violations"].extend(snap.get("violations") or [])
            block["acquisitions"] += int(snap.get("acquisitions") or 0)
            block["busy_s"] += float(snap.get("busy_s") or 0.0)
        report["witness"] = block
        if block["edge_count"] == 0:
            report["violations"].append(
                "lock-order witness recorded zero edges: the children "
                "never armed it — the soak's race check ran nothing")
        report["violations"].extend(
            "lock-order witness: " + v for v in block["violations"])
    report["ok"] = not report["violations"]
    # Separate block: must not collide with check_invariants' own keys
    # (notably the "trials" lifecycle-count dict).
    report.update(journal=journal, base_dir=base_dir,
                  kill_times=kill_times,
                  soak={"kills": kills, "seed": seed, "trials": trials,
                        "workers": workers})
    return report


if __name__ == "__main__":
    sys.exit(child_main())
