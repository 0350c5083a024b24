"""The port's monitor (``python -m maggy_tpu_torch.monitor``) against
maggy_tpu's on the CPU: every renderer gives the JAX renderer's text for the
same snapshot (synthetic ones, and live ones polled from a port sweep); a
live LOG and TELEM poll of a running port sweep through the CLI (``--once``,
``--telem``, ``--health``, ``--goodput``, ``--logs``); and ``--fleet`` over a
fleet home written by the port."""

import json
import os
import threading
import time

import pytest

from maggy_tpu import monitor as jax_monitor

from maggy_tpu_torch import OptimizationConfig, Searchspace, experiment, monitor
from maggy_tpu_torch.fleet import soak

pytestmark = [pytest.mark.torch, pytest.mark.timeout(60)]

SPACE = dict(lr=("DOUBLE", [0.0, 0.2]), units=("INTEGER", [8, 64]))

HIST = {"count": 4, "p50": 0.2, "p95": 0.9}
TELEM = {
    "type": "TELEM", "enabled": True,
    "spans": {"trials": {"created": 6, "finalized": 4, "early_stopped": 1, "errors": 0,
                         "lost": 1},
              "handoff": {"median_ms": 1.5, "p95_ms": 3.0, "n": 4},
              "early_stop_reaction": {"median_ms": 20.0, "p95_ms": 40.0, "n": 1},
              "requeue_recovery": {"median_ms": 300.0, "p95_ms": 300.0, "n": 1},
              "suggest": {"prefetch_hits": 3, "prefetch_misses": 1, "hit_rate": 0.75,
                          "latency": {"median_ms": 0.1, "p95_ms": 0.2, "n": 6}},
              "compile": {"warm_hits": 2, "warm_misses": 1, "warm_hit_rate": 0.667,
                          "ttfm_warm": {"median_ms": 5.0, "p95_ms": 6.0, "n": 2},
                          "ttfm_cold": {"median_ms": 50.0, "p95_ms": 50.0, "n": 1}},
              "fork": {"forked": 2, "from_scratch": 1, "steps_saved": 8, "ckpt_gc": 1,
                       "fork_load_ms": {"median_ms": 3.0, "p95_ms": 4.0, "n": 2}},
              "goodput": {"held_chip_s": 10.0, "goodput_fraction": 0.8,
                          "unaccounted_fraction": 0.01,
                          "buckets": {"train": 8.0, "compile": 1.0, "idle": 0.9,
                                      "rework": 0.1},
                          "per_partition": {"0": {"held_s": 10.0, "buckets": {
                              "train": 8.0, "compile": 1.0, "idle": 0.9, "rework": 0.1}}}}},
    "metrics": {"histograms": {"rpc.handle_ms.METRIC": dict(HIST, count=9),
                               "rpc.handle_ms.FINAL": HIST, "other": HIST}},
    "health": {"flags": [{"check": "hang", "partition": 1, "trial": "t1", "silent_s": 9.0,
                          "window": "startup", "bound_s": 8.0},
                         {"check": "straggler", "partition": 0, "metric": "cadence_ms",
                          "value_ms": 90.0, "fleet_median_ms": 10.0, "score": 7.2},
                         {"check": "hb_rtt", "partition": 2, "value_ms": 40.0,
                          "fleet_median_ms": 2.0},
                         {"check": "other", "partition": 3, "x": 1}],
               "raised_total": 5, "checks_run": 30},
    "runners": {"1": {"trial": "t1", "steps": 3, "cadence_ms": 10.0, "ttfm_ms": 40.0,
                      "hb_rtt_ms": 1.0, "rss_mb": 300.0},
                "0": {"trial": None}},
    "journal": {"torn_lines": 2},
}
STATUS = {"experiments": {"app/0": {
    "labels": {"experiment": "sweep"},
    "status": {"progress": {"num_trials": 9, "finalized": 4, "best_val": 0.5},
               "store": {"trials": 6, "finalized": 4, "requeue": 1},
               "reservations": {"0": {"trial": "t1"}, "1": {"trial": None}},
               "gangs": {},
               "fleet": {"fleet_size": 2, "active": 1, "queue_depth": 0}},
    "telem": TELEM}}}
FLEET_STATUS = {"name": "f", "runners": 2, "active": 1, "queue_depth": 1, "stopped": True,
                "shed": 1, "max_queued": 3,
                "experiments": [{"name": "bulk", "state": "active", "priority": "low",
                                 "weight": 1.0, "allocated": 1, "leases": 3,
                                 "preemptions": 1, "queue_wait_s": 0.1}]}
FLEET_REPLAY = {"share": {"bulk": 0.6}, "expected_share": {"bulk": 0.5}, "share_error": 0.1,
                "preemptions": 1, "sheds": 1, "experiments": {"bulk": {"queue_wait_s": 0.1}},
                "queue_wait_ms": {"median_ms": 100.0, "p95_ms": 120.0, "n": 2},
                "decisions": 12, "decisions_per_s": 3.5, "admission_p99_ms": 4.0}


@pytest.mark.parametrize("snap", [
    {"num_trials": 9, "finalized": 4, "best_val": 0.123456789, "early_stopped": 2},
    {"num_trials": 0, "finalized": 0, "best_val": None},
    {"num_workers": 4, "workers_done": 1}, {"type": "LOG", "other": 1}])
def test_render_progress_as_jax(snap):
    assert monitor.render(snap) == jax_monitor.render(snap)


@pytest.mark.parametrize("snap", [TELEM, {"type": "ERR", "error": "off"}, {"enabled": False},
                                  {**TELEM, "health": None}, {"spans": {}}])
def test_render_telem_health_and_goodput_as_jax(snap):
    for name in ("render_telem", "render_health", "render_goodput_view"):
        assert getattr(monitor, name)(snap) == getattr(jax_monitor, name)(snap), name


@pytest.mark.parametrize("status,code", [(STATUS, 503), ({"experiments": {}}, 200)])
def test_render_live_as_jax(status, code):
    healthz = {"status": "ok" if code == 200 else "unhealthy",
               "experiments": {"app/0": {"flags": TELEM["health"]["flags"]}}}
    assert monitor.render_live(status, code, healthz) == \
        jax_monitor.render_live(status, code, healthz)


@pytest.mark.parametrize("status,replay", [(FLEET_STATUS, FLEET_REPLAY), ({}, {}),
                                           (FLEET_STATUS, {})])
def test_render_fleet_as_jax(status, replay):
    assert monitor.render_fleet(status, replay) == jax_monitor.render_fleet(status, replay)


def _slow_train(lr, units, reporter=None):
    for step in range(6):
        time.sleep(0.1)
        if reporter is not None:
            reporter.broadcast(lr * (step + 1), step=step)
            reporter.log("step {}".format(step))
    return {"metric": 1.0 - (lr - 0.1) ** 2}


@pytest.mark.timeout(90)
def test_live_log_and_telem_polls_of_a_port_sweep(tmp_path, capsys):
    """The CLI polls a running port sweep through LOG and TELEM (address
    and secret from its driver_state.json), and each live snapshot renders
    to the JAX renderers' text."""
    out = {}
    config = OptimizationConfig(name="watched", num_trials=6, searchspace=Searchspace(**SPACE),
                                direction="max", num_workers=2, es_policy="none",
                                hb_interval=0.05, seed=3, experiment_dir=str(tmp_path))
    thread = threading.Thread(target=lambda: out.setdefault(
        "result", experiment.lagom(_slow_train, config)), daemon=True)
    thread.start()
    deadline = time.monotonic() + 30
    state = None
    while state is None and time.monotonic() < deadline:
        found = [os.path.join(tmp_path, d, "driver_state.json") for d in os.listdir(tmp_path)]
        found = [p for p in found if os.path.exists(p)]
        if found:
            with open(found[0]) as f:
                state = json.load(f)
        time.sleep(0.05)
    assert state is not None
    addr, secret = (state["host"], state["port"]), state["secret"]
    snaps = {}
    while not snaps.get("log", {}).get("finalized") and time.monotonic() < deadline:
        snaps["log"] = monitor.poll_progress(addr, secret)
        time.sleep(0.05)
    snaps["telem"] = monitor.poll_telemetry(addr, secret)
    assert snaps["log"]["num_trials"] == 6 and snaps["telem"]["type"] == "TELEM"
    assert monitor.render(snaps["log"]) == jax_monitor.render(snaps["log"])
    for name in ("render_telem", "render_health", "render_goodput_view"):
        assert getattr(monitor, name)(snaps["telem"]) == \
            getattr(jax_monitor, name)(snaps["telem"]), name
    driver = "{}:{}".format(*addr)
    capsys.readouterr()
    for flags in ([], ["--telem"], ["--health"], ["--goodput"], ["--logs"]):
        assert monitor.main(["--driver", driver, "--secret", secret, "--once", *flags]) == 0
        text = capsys.readouterr().out
        assert text.strip(), flags
    thread.join(60)
    assert out["result"]["num_trials"] == 6
    # After the sweep: the driver is gone, and a first poll says so.
    assert monitor.main(["--driver", driver, "--secret", secret, "--once"]) == 1


@pytest.mark.timeout(90)
def test_monitor_fleet_over_a_port_fleet_home(tmp_path, capsys):
    report = soak.run_fleet_soak(seed=7, base_dir=str(tmp_path))
    home = os.path.dirname(report["journal"])
    capsys.readouterr()
    assert monitor.main(["--fleet", home, "--once"]) == 0
    text = capsys.readouterr().out.strip()
    status, replay = monitor._poll_fleet(home)
    assert text == jax_monitor.render_fleet(status, replay)
    assert "bulk [done, prio low" in text and "urgent [done, prio high" in text
    assert "preemptions: " in text
    assert monitor.main(["--fleet", os.path.join(home, "status.json"), "--once"]) == 0
