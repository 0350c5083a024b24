"""Live observability plane: /metrics, /status, /healthz, /profilez.

The port's copy of ``maggy_tpu/telemetry/obs.py:115-430``. Replaying
``telemetry.jsonl`` tells what happened after the fact; OPERATING a
long-lived sweep needs warm-hit rates and straggler flags while the run is
live, from standard tooling. This module is the stdlib-only HTTP server
that serves them (``http.server.ThreadingHTTPServer``):

- ``GET /metrics``: the live ``MetricsRegistry`` of every registered
  experiment rendered in Prometheus text exposition format, every sample
  labeled ``experiment=".."``/``run=".."`` so one scrape config covers a
  whole fleet process. Well-known metric families get structured labels
  (``runner.<field>.p<pid>`` gauges -> a ``partition`` label,
  ``rpc.handle_ms.<verb>`` histograms -> a ``verb`` label,
  ``trial.phase.<phase>`` counters -> a ``phase`` label).
- ``GET /status``: one JSON document per registered experiment — the
  TELEM snapshot (the same body the TELEM RPC verb ships) plus the
  driver's live control-plane state: trial store / requeue backlog, the
  reservation table, the assembled gangs with the placer's blocks
  (``gangs``, ``pack``) and, for a fleet tenant, the fleet scheduler's
  share snapshot (``fleet``); a fleet host registers its own status too.
- ``GET /healthz``: 200 when no registered experiment's HealthEngine has
  an active raised finding, 503 (with the flags as JSON) otherwise — the
  shape load balancers and k8s probes expect.
- ``GET /profilez?duration_s=N``: trigger an on-demand torch.profiler
  capture (telemetry.profiling.ProfileCapturer) saved under
  ``<exp_dir>/profiles/`` and journaled as a ``profile_captured`` event.

One obs server per PROCESS: the first experiment (or fleet) that asks
starts it, later experiments register into the same listener and
deregister on stop; the listener closes when the last registration
leaves. Binding is loopback (127.0.0.1) by default — the endpoints are
unauthenticated by design (Prometheus-style), so exposing them beyond
the host is an explicit operator decision (``config.obs_host``).

Off by default: with ``config.obs_port`` unset and ``MAGGY_TPU_OBS_PORT``
absent, no socket is opened and nothing in this module runs.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional, Tuple
from urllib.parse import parse_qs, urlparse

__all__ = [
    "ObsRegistration", "ObsServer", "register", "deregister",
    "active_server", "render_prometheus",
]


# ------------------------------------------------------- prometheus text

def _sanitize(name: str) -> str:
    """Prometheus metric names are [a-zA-Z_:][a-zA-Z0-9_:]*."""
    out = []
    for i, ch in enumerate(name):
        if ch.isalnum() or ch in "_:":
            out.append(ch)
        else:
            out.append("_")
    s = "".join(out)
    if s and s[0].isdigit():
        s = "_" + s
    return s


def _escape_label(value: Any) -> str:
    return str(value).replace("\\", "\\\\").replace('"', '\\"') \
        .replace("\n", "\\n")


def _fmt_labels(labels: Dict[str, Any]) -> str:
    if not labels:
        return ""
    inner = ",".join('{}="{}"'.format(k, _escape_label(v))
                     for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _split_family(name: str) -> Tuple[str, Dict[str, str]]:
    """Map well-known registry names to a (family, extra-labels) pair so
    per-partition/per-verb/per-phase series become one labeled family
    instead of an unbounded set of metric names. Everything else keeps
    its (sanitized) name."""
    if name.startswith("runner."):
        # runner.<field>.p<pid> gauges (telemetry.record_runner_stats).
        parts = name.split(".")
        if len(parts) == 3 and parts[2].startswith("p") \
                and parts[2][1:].isdigit():
            return "runner_" + _sanitize(parts[1]), \
                {"partition": parts[2][1:]}
    if name.startswith("rpc.handle_ms."):
        return "rpc_handle_ms", {"verb": name[len("rpc.handle_ms."):]}
    if name.startswith("trial.phase."):
        return "trial_phase_total", {"phase": name[len("trial.phase."):]}
    if name.startswith("goodput.fraction.p") \
            and name[len("goodput.fraction.p"):].isdigit():
        # goodput.fraction.p<pid> gauges (Telemetry.refresh_goodput_
        # gauges) -> one labeled family, like the runner gauges.
        return "goodput_fraction", \
            {"partition": name[len("goodput.fraction.p"):]}
    if name.startswith("tenant.chip_seconds."):
        # Fleet scheduler per-tenant chip-second totals -> one family
        # labeled by tenant experiment (the autoscaler-ready signal).
        return "tenant_chip_seconds", \
            {"tenant": name[len("tenant.chip_seconds."):]}
    return _sanitize(name), {}


def render_prometheus(snapshots: List[Tuple[Dict[str, str],
                                            Dict[str, Any]]],
                      prefix: str = "maggy_tpu_") -> str:
    """Render ``[(labels, MetricsRegistry.snapshot()), ...]`` to the
    Prometheus text exposition format (version 0.0.4). Pure function —
    unit-testable without a socket."""
    # family -> type -> [(labels, payload)]
    counters: Dict[str, List] = {}
    gauges: Dict[str, List] = {}
    hists: Dict[str, List] = {}
    for base_labels, snap in snapshots:
        for name, value in (snap.get("counters") or {}).items():
            fam, extra = _split_family(name)
            counters.setdefault(fam, []).append(
                ({**base_labels, **extra}, value))
        for name, value in (snap.get("gauges") or {}).items():
            if value is None:
                continue
            fam, extra = _split_family(name)
            gauges.setdefault(fam, []).append(
                ({**base_labels, **extra}, value))
        for name, h in (snap.get("histograms") or {}).items():
            fam, extra = _split_family(name)
            hists.setdefault(fam, []).append(
                ({**base_labels, **extra}, h))
    lines: List[str] = []
    for fam in sorted(counters):
        full = prefix + fam + ("" if fam.endswith("_total") else "_total")
        lines.append("# TYPE {} counter".format(full))
        for labels, value in counters[fam]:
            lines.append("{}{} {}".format(full, _fmt_labels(labels), value))
    for fam in sorted(gauges):
        full = prefix + fam
        lines.append("# TYPE {} gauge".format(full))
        for labels, value in gauges[fam]:
            lines.append("{}{} {}".format(full, _fmt_labels(labels), value))
    for fam in sorted(hists):
        full = prefix + fam
        lines.append("# TYPE {} histogram".format(full))
        for labels, h in hists[fam]:
            # Registry buckets are per-bound occupancy; Prometheus wants
            # the cumulative CDF.
            cum = 0
            for bound, count in (h.get("buckets") or {}).items():
                cum += count
                lines.append('{}_bucket{} {}'.format(
                    full, _fmt_labels({**labels, "le": bound}), cum))
            cum += h.get("overflow", 0)
            lines.append('{}_bucket{} {}'.format(
                full, _fmt_labels({**labels, "le": "+Inf"}), cum))
            lines.append("{}_sum{} {}".format(
                full, _fmt_labels(labels), h.get("sum", 0)))
            lines.append("{}_count{} {}".format(
                full, _fmt_labels(labels), h.get("count", 0)))
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------- registrations

class ObsRegistration:
    """One experiment's hookup into the process obs server.

    Everything is a callable/reference the server reads on demand — the
    registration holds no state of its own, so a scrape always reflects
    the live system.
    """

    def __init__(self, key: str, labels: Dict[str, str], telemetry,
                 status_fn: Optional[Callable[[], Dict[str, Any]]] = None,
                 health=None, profiler=None,
                 snapshots_fn: Optional[Callable[
                     [], List[Tuple[Dict[str, str], Dict[str, Any]]]]] = None):
        self.key = key
        self.labels = dict(labels)
        self.telemetry = telemetry
        self.status_fn = status_fn
        self.health = health
        self.profiler = profiler
        #: Extra ``[(labels, registry snapshot), ...]`` rendered into
        #: /metrics beside this registration's own registry: a fleet plugs
        #: in its journal sink's per-source counters, so one scrape of the
        #: fleet host shows every agent's and tenant's shipped counters.
        self.snapshots_fn = snapshots_fn


class ObsServer:
    """ThreadingHTTPServer wrapper serving the four routes over every
    registered experiment. Handlers run on per-request daemon threads, so
    a slow scrape (or a /profilez capture) never blocks the next one —
    and never blocks any driver thread: the server only READS through
    snapshot methods that take per-structure locks briefly."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._lock = threading.Lock()
        self._regs: Dict[str, ObsRegistration] = {}  # guarded-by: _lock
        self._httpd = ThreadingHTTPServer((host, port), _ObsHandler)
        self._httpd.daemon_threads = True
        self._httpd.obs = self
        self.address: Tuple[str, int] = self._httpd.server_address[:2]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, kwargs={"poll_interval": 0.2},
            daemon=True, name="telemetry-obs")
        self._thread.start()

    # ------------------------------------------------------------- registry

    def add(self, reg: ObsRegistration) -> None:
        with self._lock:
            self._regs[reg.key] = reg

    def remove(self, key: str) -> int:
        """Drop a registration; returns how many remain."""
        with self._lock:
            self._regs.pop(key, None)
            return len(self._regs)

    def registrations(self) -> List[ObsRegistration]:
        with self._lock:
            return list(self._regs.values())

    # ------------------------------------------------------------ documents

    def metrics_text(self) -> str:
        snaps = []
        for reg in self.registrations():
            try:
                # Pre-scrape hook: fold the goodput ledger into gauges so
                # the exposition carries the CURRENT chip-time accounting
                # (the registry is otherwise only written on events).
                refresh = getattr(reg.telemetry,
                                  "refresh_goodput_gauges", None)
                if refresh is not None:
                    refresh()
                snaps.append((reg.labels,
                              reg.telemetry.metrics.snapshot()))
            except Exception:  # noqa: BLE001 - one experiment must not break the scrape
                continue
            if reg.snapshots_fn is not None:
                try:
                    snaps.extend(reg.snapshots_fn())
                except Exception:  # noqa: BLE001 - federation must not break the scrape
                    pass
        return render_prometheus(snaps)

    def status_doc(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"t": time.time(), "experiments": {}}
        for reg in self.registrations():
            doc: Dict[str, Any] = {"labels": reg.labels}
            try:
                doc["telem"] = reg.telemetry.snapshot()
                # Operator headline: the ledger's roll-up hoisted out of
                # the full spans block (which carries the detail).
                gp = (doc["telem"].get("spans") or {}).get("goodput") or {}
                if gp:
                    doc["goodput"] = {
                        "fraction": gp.get("goodput_fraction"),
                        "unaccounted_fraction":
                            gp.get("unaccounted_fraction"),
                        "held_chip_s": round(
                            gp.get("held_chip_s") or 0.0, 1),
                        "badput_top": gp.get("badput_top") or []}
            except Exception as e:  # noqa: BLE001 - scrape must degrade, not die
                doc["telem"] = {"error": repr(e)}
            if reg.status_fn is not None:
                try:
                    doc["status"] = reg.status_fn()
                except Exception as e:  # noqa: BLE001
                    doc["status"] = {"error": repr(e)}
            out["experiments"][reg.key] = doc
        return out

    def health_doc(self) -> Tuple[int, Dict[str, Any]]:
        """(http_status, body): 503 when any registered experiment has an
        active raised finding, 200 otherwise (200/"idle" with nothing
        registered — an empty fleet host is healthy)."""
        regs = self.registrations()
        if not regs:
            return 200, {"status": "idle", "experiments": {}}
        exps: Dict[str, Any] = {}
        unhealthy = False
        for reg in regs:
            if reg.health is None:
                exps[reg.key] = {"flags": [], "engine": "off"}
                continue
            try:
                snap = reg.health.snapshot()
            except Exception as e:  # noqa: BLE001
                exps[reg.key] = {"error": repr(e)}
                continue
            flags = snap.get("flags") or []
            unhealthy |= bool(flags)
            exps[reg.key] = {"flags": flags,
                             "raised_total": snap.get("raised_total")}
        return (503 if unhealthy else 200), \
            {"status": "unhealthy" if unhealthy else "ok",
             "experiments": exps}

    def profile(self, params: Dict[str, List[str]]) -> Tuple[int,
                                                             Dict[str, Any]]:
        want = (params.get("experiment") or [None])[0]
        try:
            duration = float((params.get("duration_s") or ["2.0"])[0])
        except ValueError:
            return 400, {"error": "duration_s must be a number"}
        duration = max(0.05, min(duration, 60.0))
        reg = next((r for r in self.registrations()
                    if r.profiler is not None
                    and (want is None or r.key == want)), None)
        if reg is None:
            return 404, {"error": "no registered experiment with a "
                                  "profiler (experiment={!r})".format(want)}
        record = reg.profiler.capture(duration_s=duration, reason="manual")
        if record.get("skipped"):
            return 409, record
        return 200, {"experiment": reg.key, **record}

    # ------------------------------------------------------------ lifecycle

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)


class _ObsHandler(BaseHTTPRequestHandler):
    # Scrapers poll at Hz rates; default per-request stderr logging would
    # drown the driver's own output.
    def log_message(self, format, *args):  # noqa: A002 - stdlib signature
        pass

    def _send(self, code: int, body: bytes, content_type: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, code: int, doc: Dict[str, Any]) -> None:
        self._send(code, json.dumps(doc, default=str).encode(),
                   "application/json")

    def do_GET(self):  # noqa: N802 - stdlib casing
        obs: ObsServer = self.server.obs
        parsed = urlparse(self.path)
        try:
            if parsed.path == "/metrics":
                self._send(200, obs.metrics_text().encode(),
                           "text/plain; version=0.0.4; charset=utf-8")
            elif parsed.path == "/status":
                self._send_json(200, obs.status_doc())
            elif parsed.path == "/healthz":
                code, doc = obs.health_doc()
                self._send_json(code, doc)
            elif parsed.path == "/profilez":
                code, doc = obs.profile(parse_qs(parsed.query))
                self._send_json(code, doc)
            else:
                self._send_json(404, {
                    "error": "unknown route",
                    "routes": ["/metrics", "/status", "/healthz",
                               "/profilez?duration_s=N"]})
        except (BrokenPipeError, ConnectionResetError):
            pass  # scraper went away mid-reply
        except Exception as e:  # noqa: BLE001 - a scrape bug must not kill the thread
            try:
                self._send_json(500, {"error": repr(e)})
            except OSError:
                pass


# ------------------------------------------------- process-wide singleton

_LOCK = threading.Lock()
_SERVER: Optional[ObsServer] = None


def register(reg: ObsRegistration, port: int,
             host: str = "127.0.0.1") -> ObsServer:
    """Register an experiment with the process obs server, starting it on
    first use. ``port`` 0 binds an ephemeral port (the caller journals
    the bound address as an ``obs_started`` event so tools can discover
    it). A server already running keeps ITS bind — one obs server per
    process is the contract, so a second experiment's differing
    port/host request joins the existing listener rather than opening a
    second socket."""
    global _SERVER
    with _LOCK:
        if _SERVER is None:
            _SERVER = ObsServer(host=host, port=int(port))
        server = _SERVER
        # add() must happen under the module lock: a concurrent
        # deregister() of the last OTHER registration would otherwise
        # stop the server between our read and our add, leaving this
        # experiment attached to a closed socket.
        server.add(reg)
    return server


def deregister(reg: ObsRegistration) -> None:
    """Remove a registration; the listener closes when the last one
    leaves (tests and short-lived drivers must not leak sockets)."""
    global _SERVER
    with _LOCK:
        server = _SERVER
        if server is None:
            return
        remaining = server.remove(reg.key)
        if remaining > 0:
            return
        _SERVER = None
    server.stop()


def active_server() -> Optional[ObsServer]:
    """The process's running obs server, or None. Discovery hook for
    in-process tooling (the chaos soak scraper, tests)."""
    with _LOCK:
        return _SERVER
