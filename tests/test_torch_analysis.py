"""The port's analyzer (``maggy_tpu_torch/analysis/``) against the JAX
package's (``maggy_tpu/analysis/``).

The checker and witness unit tests of ``tests/test_analysis.py`` run on the
port's copy with their fixtures copied in, and every fixture gives the same
findings through both analyzers. On the port's tree both analyzers report
no unsuppressed finding, every suppression carries a reason, and the CLI
exits 0. A port sweep on the CPU and a chaos soak run under the witness
with zero forbidden edges. The findings the analyzers raised on the port
were settled in code; their regression tests hold the port's wire to the
JAX package's (the IDLE callback reads ``last_trial``, STOP replies echo
the METRIC's ``span``, a lane FINAL is one closed literal).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time

import pytest

from maggy_tpu.analysis import analyze_paths as jax_analyze_paths
from maggy_tpu.analysis import run_analysis as jax_run_analysis
from maggy_tpu_torch.analysis import analyze_paths, package_root, run_analysis
from maggy_tpu_torch.analysis import witness as witness_mod
from maggy_tpu_torch.analysis.witness import SoakWitness, Witness

pytestmark = [pytest.mark.torch, pytest.mark.timeout(180)]

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _write(tmp_path, name, text):
    p = tmp_path / name
    p.write_text(text)
    return str(p)


def _findings(results, checker):
    return [f for f in results.get(checker, []) if not f.suppressed]


# ------------------------------------------------------------------ fixtures
# Copied from tests/test_analysis.py.


GUARDS_BAD = '''
import threading

class Store:
    def __init__(self):
        self._lock = threading.Lock()
        self._items = {}

    def put(self, k, v):
        with self._lock:
            self._items[k] = v

    def drop(self, k):
        with self._lock:
            self._items.pop(k, None)

    def rogue(self, k, v):
        self._items[k] = v  # write without the lock
'''

GUARDS_ANNOTATED_BAD = '''
import threading

class Flagged:
    def __init__(self):
        self._lock = threading.Lock()
        self._state = "idle"  # guarded-by: _lock

    def set_state(self, s):
        with self._lock:
            self._state = s

    def peek(self):
        return self._state  # unguarded READ of an annotated attr
'''

GUARDS_CLEAN = '''
import threading

class Store:
    def __init__(self):
        self._lock = threading.Lock()
        self._items = {}  # guarded-by: _lock

    def put(self, k, v):
        with self._lock:
            self._items[k] = v

    def get(self, k):
        with self._lock:
            return self._items.get(k)
'''

LOCKORDER_BAD = '''
import threading

class A:
    def __init__(self, b):
        self.l1 = threading.Lock()
        self.b = b

    def forward(self):
        with self.l1:
            with self.b.l2:
                pass

class B:
    def __init__(self, a):
        self.l2 = threading.Lock()
        self.a = a

    def backward(self):
        with self.l2:
            with self.a.l1:
                pass
'''

LOCKORDER_CLEAN = '''
import threading

class A:
    def __init__(self, b):
        self.l1 = threading.Lock()
        self.b = b

    def forward(self):
        with self.l1:
            with self.b.l2:
                pass

    def also_forward(self):
        with self.l1:
            with self.b.l2:
                pass

class B:
    def __init__(self, a):
        self.l2 = threading.Lock()
        self.a = a
'''

LOCKORDER_CALL = '''
import threading

class C:
    def __init__(self):
        self.outer = threading.Lock()
        self.inner = threading.Lock()

    def leaf(self):
        with self.inner:
            pass

    def top(self):
        with self.outer:
            self.leaf()

    def inverted(self):
        with self.inner:
            with self.outer:
                pass
'''

RPCCONF_BAD = '''
class MiniServer:
    def __init__(self):
        self._handlers = {}
        self._register_handlers()

    def _register_handlers(self):
        self._handlers["PING"] = self._ping
        self._handlers["GHOST"] = self._ghost

    def _ping(self, msg):
        return {"type": "OK", "echo": msg["payload"], "extra": msg["missing"]}

    def _ghost(self, msg):
        return {"type": "OK"}

    def handle_message(self, msg):
        t0 = 0
        self.metrics.histogram("rpc.handle_ms." + msg["type"]).observe(t0)
        return self._handlers[msg["type"]](msg)


class MiniClient:
    def ping(self):
        return self._request({"type": "PING", "payload": "x",
                              "dead_key": 1})
'''

RPCCONF_CLEAN = '''
class MiniServer:
    def __init__(self):
        self._handlers = {}
        self._register_handlers()

    def _register_handlers(self):
        self._handlers["PING"] = self._ping

    def _ping(self, msg):
        return {"type": "OK", "echo": msg["payload"]}

    def handle_message(self, msg):
        t0 = 0
        self.metrics.histogram("rpc.handle_ms." + msg["type"]).observe(t0)
        return self._handlers[msg["type"]](msg)


class MiniClient:
    def ping(self):
        return self._request({"type": "PING", "payload": "x"})
'''

VOCAB_FIXTURE = '''
SPAN_PHASES = ("queued", "running")
EVENT_KINDS = frozenset({"trial"})
REQUEUE_REASONS = frozenset()
'''

EMIT_CLEAN = '''
def emit_all(t, tid):
    t.trial_event(tid, "queued")
    t.trial_event(tid, "running")
    t.event("trial", phase="queued")

def consume(ev):
    return ev.get("phase") == "running"
'''

EMIT_TYPO = '''
def emit_all(t, tid):
    t.trial_event(tid, "queued")
    t.trial_event(tid, "running")
    t.event("trial")
    t.trial_event(tid, "runing")  # emitter typo
'''

CONSUME_TYPO = '''
def emit_all(t, tid):
    t.trial_event(tid, "queued")
    t.trial_event(tid, "running")
    t.event("trial")

def consume(ev):
    return ev.get("phase") == "runningg"  # consumer typo
'''

EMIT_ONE = ('def emit_all(t, tid):\n'
            '    t.trial_event(tid, "queued")\n'
            '    t.event("trial")\n')

#: name -> (files, checkers): every fixture of the checker tests, with the
#: variants those tests make by replacement.
FIXTURES = {
    "guards_bad": ({"g_bad.py": GUARDS_BAD}, ("guards",)),
    "guards_annotated_bad": ({"g_ann.py": GUARDS_ANNOTATED_BAD}, ("guards",)),
    "guards_clean": ({"g_clean.py": GUARDS_CLEAN}, ("guards",)),
    "guards_typed": ({"g_typed.py": GUARDS_ANNOTATED_BAD.replace(
        'self._state = "idle"  # guarded-by: _lock',
        'self._state: str = "idle"  # guarded-by: _lock')}, ("guards",)),
    "guards_suppressed": ({"g_supp.py": GUARDS_ANNOTATED_BAD.replace(
        "return self._state  # unguarded READ of an annotated attr",
        "return self._state  # unguarded-ok: racy peek is advisory")}, ("guards",)),
    "guards_reasonless": ({"g_noreason.py": GUARDS_ANNOTATED_BAD.replace(
        "return self._state  # unguarded READ of an annotated attr",
        "return self._state  # unguarded-ok:")}, ("guards",)),
    "lockorder_bad": ({"lo_bad.py": LOCKORDER_BAD}, ("lockorder",)),
    "lockorder_clean": ({"lo_clean.py": LOCKORDER_CLEAN}, ("lockorder",)),
    "lockorder_suppressed": ({"lo_supp.py": LOCKORDER_BAD.replace(
        "        with self.l2:\n            with self.a.l1:",
        "        with self.l2:\n            # lock-order-ok: proven never concurrent with "
        "forward\n            with self.a.l1:")}, ("lockorder",)),
    "lockorder_call": ({"lo_call.py": LOCKORDER_CALL}, ("lockorder",)),
    "rpcconf_bad": ({"rpc_bad.py": RPCCONF_BAD}, ("rpcconf",)),
    "rpcconf_clean": ({"rpc_clean.py": RPCCONF_CLEAN}, ("rpcconf",)),
    "rpcconf_untimed": ({"rpc_untimed.py": RPCCONF_CLEAN.replace(
        '        self.metrics.histogram("rpc.handle_ms." + msg["type"]).observe(t0)\n',
        "")}, ("rpcconf",)),
    "rpcconf_suppressed": ({"rpc_supp.py": RPCCONF_BAD.replace(
        '        self._handlers["GHOST"] = self._ghost',
        '        # rpc-ok: produced by an external CLI, invisible here\n'
        '        self._handlers["GHOST"] = self._ghost')}, ("rpcconf",)),
    "vocab_emit_typo": ({"vocab.py": VOCAB_FIXTURE, "emit.py": EMIT_TYPO},
                        ("journalvocab",)),
    "vocab_orphan": ({"vocab.py": VOCAB_FIXTURE, "emit.py": EMIT_ONE}, ("journalvocab",)),
    "vocab_consume_typo": ({"vocab.py": VOCAB_FIXTURE, "code.py": CONSUME_TYPO},
                           ("journalvocab",)),
    "vocab_clean": ({"vocab.py": VOCAB_FIXTURE, "code.py": EMIT_CLEAN}, ("journalvocab",)),
}


def _fixture(tmp_path, name):
    files, checkers = FIXTURES[name]
    return [_write(tmp_path, fname, text) for fname, text in files.items()], checkers


def _summary(results):
    return sorted((checker, os.path.basename(f.path), f.line, f.message, f.suppressed,
                   f.reason) for checker, fs in results.items() for f in fs)


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_every_fixture_gives_the_jax_analyzers_findings(tmp_path, name):
    paths, checkers = _fixture(tmp_path, name)
    assert _summary(analyze_paths(paths, checkers=checkers)) == \
        _summary(jax_analyze_paths(paths, checkers=checkers))


# ------------------------------------------------------------------ checkers


class TestGuardsChecker:
    def test_inferred_unguarded_write_fires(self, tmp_path):
        paths, checkers = _fixture(tmp_path, "guards_bad")
        out = _findings(analyze_paths(paths, checkers=checkers), "guards")
        assert len(out) == 1
        assert "write of Store._items without holding" in out[0].message
        assert out[0].line == GUARDS_BAD.splitlines().index(
            "        self._items[k] = v  # write without the lock") + 1

    def test_annotated_unguarded_read_fires(self, tmp_path):
        for name in ("guards_annotated_bad", "guards_typed"):
            paths, checkers = _fixture(tmp_path, name)
            out = _findings(analyze_paths(paths, checkers=checkers), "guards")
            assert len(out) == 1
            assert "read of Flagged._state" in out[0].message
            assert "guarded-by annotation" in out[0].message

    def test_clean_fixture_is_quiet(self, tmp_path):
        paths, checkers = _fixture(tmp_path, "guards_clean")
        assert _findings(analyze_paths(paths, checkers=checkers), "guards") == []

    def test_unguarded_ok_suppresses_with_reason(self, tmp_path):
        paths, checkers = _fixture(tmp_path, "guards_suppressed")
        results = analyze_paths(paths, checkers=checkers)
        assert _findings(results, "guards") == []
        supp = [f for f in results["guards"] if f.suppressed]
        assert len(supp) == 1 and supp[0].reason == "racy peek is advisory"

    def test_reasonless_suppression_is_a_finding(self, tmp_path):
        paths, checkers = _fixture(tmp_path, "guards_reasonless")
        out = _findings(analyze_paths(paths, checkers=checkers), "guards")
        assert len(out) == 1 and "without a reason" in out[0].message


class TestLockOrderChecker:
    def test_cycle_fires(self, tmp_path):
        paths, checkers = _fixture(tmp_path, "lockorder_bad")
        out = _findings(analyze_paths(paths, checkers=checkers), "lockorder")
        assert len(out) == 1 and "lock-order cycle" in out[0].message
        assert "A.l1" in out[0].message and "B.l2" in out[0].message

    def test_consistent_order_is_quiet_and_canonical(self, tmp_path):
        from maggy_tpu_torch.analysis.astindex import parse_package
        from maggy_tpu_torch.analysis.lockorder import build_graph, canonical_order

        paths, checkers = _fixture(tmp_path, "lockorder_clean")
        assert _findings(analyze_paths(paths, checkers=checkers), "lockorder") == []
        order = canonical_order(build_graph(parse_package(None, paths=paths)))
        assert order.index("A.l1") < order.index("B.l2")

    def test_suppressed_edge_with_reason_breaks_the_cycle(self, tmp_path):
        paths, checkers = _fixture(tmp_path, "lockorder_suppressed")
        assert _findings(analyze_paths(paths, checkers=checkers), "lockorder") == []

    def test_call_crossing_edge_detected(self, tmp_path):
        paths, checkers = _fixture(tmp_path, "lockorder_call")
        out = _findings(analyze_paths(paths, checkers=checkers), "lockorder")
        assert len(out) == 1 and "lock-order cycle" in out[0].message

    def test_a_module_singletons_aliased_methods_are_followed(self, tmp_path):
        """The port's layout the JAX analyzer does not follow:
        ``device_gate``'s gate is a module singleton whose bound methods
        are the module's functions. Holding a lock while entering
        ``gate.quiesce()`` is an edge to the gate's condition."""
        from maggy_tpu_torch.analysis.astindex import parse_package
        from maggy_tpu_torch.analysis.lockorder import build_graph

        gate = _write(tmp_path, "gate.py", (
            "import threading\n\n"
            "class _Gate:\n"
            "    def __init__(self):\n"
            "        self._cond = threading.Condition()\n\n"
            "    def exclusive(self):\n"
            "        with self._cond:\n"
            "            pass\n\n"
            "    capture = quiesce = exclusive\n\n"
            "_GATE = _Gate()\n"
            "quiesce = _GATE.quiesce\n"))
        user = _write(tmp_path, "user.py", (
            "import threading\n"
            "import gate\n\n"
            "_LOCK = threading.Lock()\n\n"
            "def capture():\n"
            "    with _LOCK:\n"
            "        gate.quiesce()\n"))
        graph = build_graph(parse_package(None, paths=[gate, user]))
        assert ("user._LOCK", "_Gate._cond") in graph.edges

    def test_the_port_tree_has_the_gate_edge(self):
        report = run_analysis(checkers=("lockorder",))
        assert "maggy_tpu_torch.telemetry.profiling._CAPTURE_LOCK -> _Gate._cond" in \
            report["lock_edges"]


class TestRpcConfChecker:
    def test_bad_fixture_fires_all_three_ways(self, tmp_path):
        paths, checkers = _fixture(tmp_path, "rpcconf_bad")
        msgs = "\n".join(f.message for f in _findings(
            analyze_paths(paths, checkers=checkers), "rpcconf"))
        assert "verb GHOST is registered but has no producer" in msgs
        assert "indexes msg['missing']" in msgs
        assert "sends key 'dead_key'" in msgs

    def test_clean_fixture_is_quiet(self, tmp_path):
        paths, checkers = _fixture(tmp_path, "rpcconf_clean")
        assert _findings(analyze_paths(paths, checkers=checkers), "rpcconf") == []

    def test_missing_dispatch_timing_fires(self, tmp_path):
        paths, checkers = _fixture(tmp_path, "rpcconf_untimed")
        out = _findings(analyze_paths(paths, checkers=checkers), "rpcconf")
        assert len(out) == 1
        assert "no rpc.handle_ms.<verb> dispatch timing" in out[0].message

    def test_rpc_ok_suppresses(self, tmp_path):
        paths, checkers = _fixture(tmp_path, "rpcconf_suppressed")
        out = _findings(analyze_paths(paths, checkers=checkers), "rpcconf")
        assert not any("GHOST" in f.message for f in out)


class TestJournalVocabChecker:
    def test_emitter_typo_fires(self, tmp_path):
        paths, checkers = _fixture(tmp_path, "vocab_emit_typo")
        out = _findings(analyze_paths(paths, checkers=checkers), "journalvocab")
        assert len(out) == 1
        assert "emitted phase 'runing' is not in the journal" in out[0].message

    def test_orphan_vocab_entry_fires(self, tmp_path):
        paths, checkers = _fixture(tmp_path, "vocab_orphan")
        out = _findings(analyze_paths(paths, checkers=checkers), "journalvocab")
        assert len(out) == 1
        assert "vocabulary entry 'running'" in out[0].message
        assert "never emitted" in out[0].message

    def test_consumer_typo_fires(self, tmp_path):
        paths, checkers = _fixture(tmp_path, "vocab_consume_typo")
        out = _findings(analyze_paths(paths, checkers=checkers), "journalvocab")
        assert len(out) == 1
        assert "consumer matches phase 'runningg'" in out[0].message

    def test_clean_fixture_is_quiet(self, tmp_path):
        paths, checkers = _fixture(tmp_path, "vocab_clean")
        assert _findings(analyze_paths(paths, checkers=checkers), "journalvocab") == []

    def test_port_vocab_module_exists(self):
        from maggy_tpu_torch.telemetry import vocab

        assert "queued" in vocab.SPAN_PHASES and "trial" in vocab.EVENT_KINDS
        assert vocab.REQUEUE_REASONS <= vocab.ALL_REASONS


# ------------------------------------------------------------------- witness


class TestWitnessUnit:
    def test_forbidden_edge_is_a_violation(self):
        w = Witness(["A.x", "B.y"])
        w.note_acquire(1, "B.y")
        w.note_acquire(2, "A.x")
        assert len(w.violations) == 1
        assert (w.violations[0].held, w.violations[0].acquired) == ("B.y", "A.x")
        with pytest.raises(AssertionError):
            w.check()

    def test_canonical_order_edge_is_clean(self):
        w = Witness(["A.x", "B.y"])
        w.note_acquire(1, "A.x")
        w.note_acquire(2, "B.y")
        assert w.violations == [] and ("A.x", "B.y") in w.edges
        w.check()
        snap = w.snapshot()
        assert snap["acquisitions"] == 2 and snap["busy_s"] >= 0.0

    def test_release_unwinds_held_set(self):
        w = Witness(["A.x", "B.y"])
        w.note_acquire(1, "B.y")
        w.note_release(1)
        w.note_acquire(2, "A.x")
        assert w.violations == [] and w.edges == {}

    def test_two_instances_of_one_decl_are_unordered(self):
        w = Witness(["Trial.lock"])
        w.note_acquire(1, "Trial.lock")
        w.note_acquire(2, "Trial.lock")
        assert w.violations == [] and w.edges == {}

    def test_forbidden_edge_records_every_occurrence(self):
        w = Witness(["A.x", "B.y"])
        for _ in range(2):
            w.note_acquire(1, "B.y")
            w.note_acquire(2, "A.x")
            w.note_release(2)
            w.note_release(1)
        assert len(w.violations) == 2 and len(w.edges) == 1

    def test_site_named_locks_record_but_never_violate(self):
        w = Witness(["A.x"])
        w.note_acquire(1, "some/file.py:10")
        w.note_acquire(2, "A.x")
        assert ("some/file.py:10", "A.x") in w.edges and w.violations == []


class TestWitnessInstall:
    def test_package_lock_wrapped_foreign_lock_passthrough(self):
        w = witness_mod.install()
        try:
            from maggy_tpu_torch.telemetry.metrics import MetricsRegistry

            reg = MetricsRegistry()
            assert type(reg._lock).__name__ == "_WitnessLock"
            assert reg._lock._name == "MetricsRegistry._lock"
            foreign = threading.Lock()
            assert type(foreign).__name__ != "_WitnessLock"
            reg.counter("c").inc()
            assert reg.counter("c").value == 1
        finally:
            witness_mod.uninstall()
        assert threading.Lock is witness_mod._REAL_LOCK
        assert w.violations == []

    def test_install_is_idempotent(self):
        w1 = witness_mod.install()
        try:
            assert witness_mod.install() is w1
        finally:
            witness_mod.uninstall()

    def test_env_var_arms_the_soak_witness(self, monkeypatch):
        monkeypatch.delenv(witness_mod.ENV_VAR, raising=False)
        assert SoakWitness(None).witness is None
        assert SoakWitness(False).witness is None
        monkeypatch.setenv(witness_mod.ENV_VAR, "1")
        soak = SoakWitness(None)
        try:
            assert soak.witness is witness_mod.active_witness() is not None
            assert soak.reading()["violations"] == []
        finally:
            soak.release()
            assert witness_mod.active_witness() is not None  # env-armed: stays
            witness_mod.uninstall()

    def test_condition_over_wrapped_rlock(self):
        witness_mod.install()
        try:
            from maggy_tpu_torch.fleet.scheduler import FleetScheduler

            sched = FleetScheduler(fleet_size=1)
            assert type(sched._lock).__name__ == "_WitnessLock"
            woke = []

            def waiter():
                with sched._wake:
                    woke.append(sched._wake.wait(timeout=2.0))

            t = threading.Thread(target=waiter)
            t.start()
            time.sleep(0.1)
            with sched._wake:
                sched._wake.notify_all()
            t.join(timeout=5)
            assert woke == [True]
            with sched._lock:
                with sched._lock:
                    pass
            assert witness_mod.active_witness().violations == []
        finally:
            witness_mod.uninstall()

    def test_forbidden_runtime_edge_detected(self):
        w = witness_mod.install()
        try:
            from maggy_tpu_torch.fleet.scheduler import FleetScheduler
            from maggy_tpu_torch.telemetry.metrics import MetricsRegistry

            sched = FleetScheduler(fleet_size=1)
            reg = MetricsRegistry()
            a, b = sorted([(w.positions["FleetScheduler._lock"], sched._lock),
                           (w.positions["MetricsRegistry._lock"], reg._lock)],
                          key=lambda p: p[0])
            with a[1]:
                with b[1]:
                    pass
            assert w.violations == []
            with b[1]:
                with a[1]:
                    pass
            assert len(w.violations) == 1
        finally:
            witness_mod.uninstall()


def _witness_train(lr, units, reporter=None):
    acc = 1.0 - ((lr - 0.1) ** 2 + ((units - 32) / 64.0) ** 2)
    for step in range(3):
        time.sleep(0.02)
        if reporter is not None:
            reporter.broadcast(acc * (step + 1) / 3.0, step=step)
    return {"metric": acc}


def test_a_port_sweep_under_the_witness_takes_no_forbidden_edge(tmp_path):
    from maggy_tpu_torch import OptimizationConfig, Searchspace, experiment

    w = witness_mod.install()
    try:
        result = experiment.lagom(_witness_train, OptimizationConfig(
            name="witnessed", num_trials=4, optimizer="randomsearch",
            searchspace=Searchspace(lr=("DOUBLE", [0.0, 0.2]), units=("INTEGER", [8, 64])),
            direction="max", num_workers=2, hb_interval=0.02, seed=5, es_policy="none",
            experiment_dir=str(tmp_path)))
    finally:
        witness_mod.uninstall()
    assert result["num_trials"] == 4
    snap = w.snapshot()
    assert snap["edge_count"] > 0, "a real experiment must exercise nested acquisitions"
    assert snap["violations"] == []


def test_a_chaos_soak_under_the_witness_takes_no_forbidden_edge(tmp_path):
    from maggy_tpu_torch.chaos import harness

    report = harness.run_soak(seed=7, num_trials=8, base_dir=str(tmp_path),
                              lock_witness=True)
    assert report["ok"], report["violations"]
    assert report["witness"]["edge_count"] > 0
    assert report["witness"]["violations"] == []
    assert report["witness"]["acquisitions"] > 0
    assert witness_mod.active_witness() is None  # installed here, uninstalled here


# ------------------------------------------------------- the port's own tree


@pytest.fixture(scope="module")
def reports():
    return {"port": run_analysis(), "jax": jax_run_analysis(root=package_root())}


@pytest.mark.parametrize("analyzer", ["port", "jax"])
def test_the_port_tree_analyzes_clean(reports, analyzer):
    report = reports[analyzer]
    assert report["findings"] == [], "unannotated findings:\n" + "\n".join(
        repr(f) for f in report["findings"])
    for f in report["suppressed"]:
        assert f.reason, "reasonless suppression: {!r}".format(f)
    assert report["num_locks"] >= 40
    assert len(report["lock_order"]) == len(set(report["lock_order"])) >= 40


def test_package_root_is_the_port():
    assert package_root() == os.path.join(ROOT, "maggy_tpu_torch")


def test_cli_exits_zero_and_writes_the_ports_doc(tmp_path, capsys):
    from maggy_tpu_torch.analysis.__main__ import DEFAULT_DOCS, DOCS_BEGIN, DOCS_END, main

    assert DEFAULT_DOCS == os.path.join(ROOT, "docs", "analysis_torch.md")
    assert main([]) == 0
    assert "0 finding(s)" in capsys.readouterr().out
    doc = tmp_path / "doc.md"
    doc.write_text("# doc\n{}\nstale\n{}\n".format(DOCS_BEGIN, DOCS_END))
    assert main(["--write-docs", str(doc)]) == 0
    capsys.readouterr()
    text = doc.read_text()
    assert "stale" not in text and "`_Gate._cond`" in text
    assert main(["--json"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["findings"] == [] and report["num_locks"] >= 40


def test_the_committed_doc_is_current():
    from maggy_tpu_torch.analysis.__main__ import (DEFAULT_DOCS, DOCS_BEGIN, DOCS_END,
                                                   render_lock_order)

    with open(DEFAULT_DOCS) as f:
        text = f.read()
    section = text.split(DOCS_BEGIN, 1)[1].split(DOCS_END, 1)[0]
    assert section == "\n" + render_lock_order(run_analysis(checkers=("lockorder",)))


def test_the_analyzer_imports_no_torch_and_no_code_under_analysis():
    script = (
        "import json, sys\n"
        "sys.path.insert(0, {root!r})\n"
        "import maggy_tpu_torch\n"
        "before = set(sys.modules)\n"
        "from maggy_tpu_torch.analysis import run_analysis, witness\n"
        "assert run_analysis()['findings'] == []\n"
        "new = sorted(m for m in set(sys.modules) - before if m.startswith('maggy_tpu'))\n"
        "print(json.dumps({{'torch': 'torch' in sys.modules, 'new': new}}))\n").format(root=ROOT)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          timeout=120, env=env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["torch"] is False
    assert all(m.startswith("maggy_tpu_torch.analysis") for m in out["new"]), out["new"]


# ------------------------------------------------- settled findings, as JAX


class _Reservations:
    def __init__(self, assigned=None):
        self.assigned = assigned

    def touch(self, pid):
        pass

    def pop_stop(self, pid, trial_id):
        return False

    def get_assigned_trial(self, pid):
        return self.assigned


class _StoppedTrial:
    def get_early_stop(self):
        return True

    def get_preempt(self):
        return False


class _Driver:
    def enqueue(self, msg):
        pass

    def get_trial(self, trial_id):
        return _StoppedTrial()

    def block_leader(self, trial_id):
        return None


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_a_stop_reply_echoes_the_metrics_span(pkg):
    """METRIC's ``span`` is read: the STOP reply echoes it (JAX
    ``rpc.py:1331-1385``), so the runner can attribute the abort."""
    if pkg == "jax":
        from maggy_tpu.core.rpc import OptimizationServer
    else:
        from maggy_tpu_torch.core.rpc import OptimizationServer
    server = object.__new__(OptimizationServer)
    server.reservations = _Reservations(assigned="t1")
    server.driver = _Driver()
    server.telemetry = None
    server._note_adopted = lambda pid: None
    reply = server._metric({"type": "METRIC", "partition_id": 0, "trial_id": "t1",
                            "value": 0.5, "step": 1, "logs": [], "span": "span-t1"})
    assert reply == {"type": "STOP", "span": "span-t1", "preempt": False}


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_the_idle_callback_reports_last_trial(pkg):
    """IDLE's ``last_trial`` is read, as JAX ``optimization_driver.py:1595``
    reads it, and the idle timer sends it (None)."""
    if pkg == "jax":
        from maggy_tpu.core.driver.optimization_driver import OptimizationDriver
    else:
        from maggy_tpu_torch.core.driver.optimization_driver import OptimizationDriver
    calls = []
    driver = object.__new__(OptimizationDriver)
    driver._assign_next = lambda pid, last: calls.append((pid, last))

    class _Server:
        reservations = _Reservations()

    driver.server = _Server()
    marker = object()
    driver._idle_msg_callback({"type": "IDLE", "partition_id": 3, "last_trial": marker})
    assert calls == [(3, marker)]
    sent = []
    driver.enqueue = sent.append
    driver._rearm_idle(4)
    deadline = time.monotonic() + 5
    while not sent and time.monotonic() < deadline:
        time.sleep(0.05)
    assert sent == [{"type": "IDLE", "partition_id": 4, "last_trial": None}]


def _lane_finals(pkg):
    if pkg == "jax":
        from maggy_tpu.core import rpc
        from maggy_tpu.core.reporter import Reporter
    else:
        from maggy_tpu_torch.core import rpc
        from maggy_tpu_torch.core.reporter import Reporter
    sent = []
    client = object.__new__(rpc.Client)
    client.last_info = {"epoch": 3}
    client._request = lambda msg, **kw: (sent.append(dict(msg)), {"type": "OK"})[1]
    client._handle_final_reply = lambda resp: None
    client._bank = lambda resp: None
    reporter = Reporter()
    reporter.reset(trial_id="lead")
    client.finalize_lane("t0", 0.5, reporter, lane=0, block="lead", epoch=1)
    client.finalize_lane("t1", None, reporter, lane=1, block="lead", epoch=2, last=True,
                         error=True)
    return sent


def test_a_lane_final_carries_the_jax_keys():
    """The port's lane FINAL is one closed literal with its verb, so the
    analyzer sees ``block`` sent; the frames carry the JAX client's keys."""
    ours, ref = _lane_finals("port"), _lane_finals("jax")
    assert [sorted(m) for m in ours] == [sorted(m) for m in ref]
    assert [(m["type"], m["block"], m["lane"], m["last"]) for m in ours] == \
        [("FINAL", "lead", 0, False), ("FINAL", "lead", 1, True)]
    assert ours[1]["error"] is True and ours[1]["value"] is None
