"""Live in-process telemetry endpoint: scrape metrics, probe health,
pull phase profiles and flight-recorder rings over HTTP.

The observability stack (docs/observability.md) is pull-from-Python:
``ctx.metrics()`` / ``ctx.profile()`` / ``ctx.flightrec()`` all require
application-code cooperation. A production fleet wants the opposite —
Prometheus scrapes ``/metrics`` on its own schedule, an orchestrator
health-checks ``/healthz``, and an engineer curls a live rank's
``/profile.json`` mid-incident without touching the training loop.
:func:`serve_telemetry` starts a daemon-thread HTTP server bound to a
context (or any object with the same ``metrics()``/``profile()``/
``flightrec()`` surface, e.g. an ``ElasticContext``):

======================  ================================================
``GET /metrics``        Prometheus text exposition (utils.metrics)
``GET /healthz``        200 when healthy; 503 with a JSON reason list
                        when the watchdog recently recorded a stall, a
                        transport failure was observed, or the elastic
                        plane shows this worker superseded / evicted /
                        below min size
``GET /profile.json``   the phase profiler's per-op breakdown ring
``GET /spans``          the causal span recorder's step-level ring
                        (docs/critpath.md; feed tools/critpath_view.py)
``GET /flightrec``      the always-on flight-recorder ring
``GET /fleet``          the merged fleet observability document (rank 0
                        with ``ctx.fleetobs_start()`` running: coverage,
                        straggler leaderboard, slow links, anomalies;
                        a role stub elsewhere — docs/fleet.md)
``POST /flightrec/dump``  write this rank's ring to the dump directory
                        (guarded: POST-only, plus the ``token`` check
                        below when configured)
======================  ================================================

Security: the server binds ``127.0.0.1`` by default — these endpoints
expose operational detail (peer addresses, error strings) and the dump
route writes files, so exposing them beyond the host is an explicit
opt-in (``host="0.0.0.0"``) that should ride behind ``token=`` /
``TPUCOLL_TELEMETRY_TOKEN``. When a token is configured EVERY route
requires it (``X-TpuColl-Token`` header or ``?token=`` query
parameter); without one, the dump route is still POST-only.

The port comes from ``port=``, else ``TPUCOLL_TELEMETRY_PORT`` (strict
integer parse — a typo'd value raises instead of silently picking an
ephemeral port), else 0 (ephemeral; read ``server.port``).

The port's copy of gloo_tpu/utils/telemetry.py, kept so that the port
imports nothing of the JAX package: the same functions over the same
documents, which the port's own build of the native core emits.
"""

from __future__ import annotations

import hmac
import json
import os
import threading
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional
from urllib.parse import parse_qs, urlparse

from gloo_tpu_torch.utils import metrics as metrics_util

__all__ = ["TelemetryServer", "fetch_route", "serve_telemetry"]


def fetch_route(source: str, route: str, timeout: float = 10.0,
                token: Optional[str] = None):
    """Fetch one telemetry route from a live rank and parse the JSON.

    ``source`` is an ``http(s)://host:port`` base (``route`` — e.g.
    ``"/flightrec"`` or ``"/profile.json"`` — is appended unless the
    source already ends with it). ``token`` (default: the
    ``TPUCOLL_TELEMETRY_TOKEN`` environment variable) rides the
    ``X-TpuColl-Token`` header for token-guarded endpoints. The one
    fetch path shared by ``tools/flightrec_view.py`` and
    ``tools/profile_view.py`` (via ``tools/_telemetry_client.py``) so
    their live-source handling cannot drift."""
    url = source.rstrip("/")
    if not url.endswith(route):
        url += route
    if token is None:
        token = os.environ.get("TPUCOLL_TELEMETRY_TOKEN") or None
    req = urllib.request.Request(
        url, headers={"X-TpuColl-Token": token} if token else {})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.load(resp)


def _env_port() -> int:
    raw = os.environ.get("TPUCOLL_TELEMETRY_PORT")
    if raw is None or raw == "":
        return 0
    if not raw.isdigit() or int(raw) > 65535:
        raise ValueError(
            f"TPUCOLL_TELEMETRY_PORT must be a port number in [0, 65535], "
            f"got: {raw!r}")
    return int(raw)


def healthz(snapshot: dict, stall_window_ms: Optional[float] = None,
            ) -> dict:
    """Health verdict over one metrics snapshot: ``{"ok": bool,
    "reasons": [...], ...}``.

    A watchdog stall marks the rank unhealthy while the stall is
    FRESH — within ``stall_window_ms`` (default ``max(3 * watchdog_ms,
    1000)``) of detection — **or still unresolved**: the watchdog
    records a stall at most once per blocked wait, so age alone would
    read a rank wedged in a 60 s collective as healthy after a second;
    as long as the blamed peer has made no transport progress since the
    stall was detected, the rank is still stuck and stays 503. Once the
    peer progressed (the link resumed) the record ages out past the
    window and the verdict flips back to 200 without a manual drain. A
    recorded transport failure is permanent for the context (the mesh
    is poisoned). Elastic status (attached by
    ``ElasticContext.metrics()``) is unhealthy when this worker is
    superseded (bound epoch behind the head), evicted / join-pending,
    or the group sits below min_size."""
    reasons: List[str] = []
    wd = snapshot.get("watchdog", {}) or {}
    last = wd.get("last")
    if last:
        if stall_window_ms is None:
            stall_window_ms = max(
                3 * float(snapshot.get("watchdog_ms", 0) or 0), 1000.0)
        age_ms = float(last.get("age_us", 0)) / 1000.0
        peer = last.get("peer", -1)
        transport = snapshot.get("transport", {}) or {}
        peer_stats = (transport.get(peer) or transport.get(str(peer))
                      or {})
        # Resolved = the blamed peer moved bytes AFTER the stall was
        # detected (timestamps share the rank's steady clock). An
        # unknown peer (-1, recv-from-any) can't be checked and falls
        # back to freshness alone.
        resolved = (peer is None or peer < 0 or
                    peer_stats.get("last_progress_us", 0)
                    > last.get("at_us", 0))
        if age_ms <= stall_window_ms or not resolved:
            detail = ("" if resolved
                      else ", unresolved: peer has not progressed since")
            reasons.append(
                f"watchdog stall {age_ms:.0f}ms ago (peer "
                f"{last.get('peer')}, waited "
                f"{last.get('waited_us', 0) // 1000}ms{detail})")
    failure = snapshot.get("transport_failure")
    if failure:
        reasons.append(
            f"transport failure: peer {failure.get('peer')} "
            f"({failure.get('message', '')[:120]})")
    elastic = snapshot.get("elastic")
    out = {"rank": snapshot.get("rank"), "group": snapshot.get("group")}
    if elastic:
        out["epoch"] = elastic.get("epoch")
        out["head_epoch"] = elastic.get("head_epoch")
        out["members"] = elastic.get("size")
        if elastic.get("join_pending"):
            reasons.append("elastic: not a member of the current epoch "
                           "(evicted or join pending)")
        elif elastic.get("head_epoch", 0) > elastic.get("epoch", 0):
            reasons.append(
                f"elastic: superseded (bound epoch {elastic.get('epoch')}"
                f" behind head {elastic.get('head_epoch')})")
        if (elastic.get("min_size") and
                elastic.get("size", 0) < elastic["min_size"]):
            reasons.append(
                f"elastic: {elastic.get('size')} members below min_size "
                f"{elastic['min_size']}")
    out["ok"] = not reasons
    out["reasons"] = reasons
    return out


class TelemetryServer:
    """Daemon-thread HTTP server bound to one context. Create via
    :func:`serve_telemetry`; stop with :meth:`close` (also a context
    manager). The serving thread never blocks interpreter exit."""

    def __init__(self, ctx, host: str, port: int, token: Optional[str],
                 stall_window_ms: Optional[float]):
        self._ctx = ctx
        self._token = token
        self._stall_window_ms = stall_window_ms
        outer = self

        class Handler(BaseHTTPRequestHandler):
            # The handler must never raise into the socket loop; every
            # route snapshot failure becomes a 500 with the message.
            def log_message(self, *args):  # noqa: D102 - silence stderr
                pass

            def _reply(self, code: int, body: bytes,
                       ctype: str = "application/json") -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _reply_json(self, code: int, doc) -> None:
                self._reply(code, json.dumps(doc).encode())

            def _authorized(self, parsed) -> bool:
                """With a token configured, EVERY route requires it —
                the GET routes expose the same operational detail
                (peer addresses, error strings) the token exists to
                guard. Constant-time compare: a short-circuiting !=
                would leak the token byte by byte through response
                timing on a deliberately network-exposed server."""
                if not outer._token:
                    return True
                query = parse_qs(parsed.query)
                given = (self.headers.get("X-TpuColl-Token")
                         or (query.get("token") or [None])[0])
                return hmac.compare_digest(given or "", outer._token)

            def do_GET(self):  # noqa: N802 - http.server contract
                try:
                    parsed = urlparse(self.path)
                    path = parsed.path
                    if not self._authorized(parsed):
                        self._reply_json(
                            403, {"error": "bad or missing token"})
                        return
                    if path == "/metrics":
                        text = metrics_util.to_prometheus(
                            outer._ctx.metrics())
                        self._reply(200, text.encode(),
                                    "text/plain; version=0.0.4")
                    elif path == "/healthz":
                        verdict = healthz(outer._ctx.metrics(),
                                          outer._stall_window_ms)
                        self._reply_json(200 if verdict["ok"] else 503,
                                         verdict)
                    elif path == "/profile.json":
                        self._reply_json(200, outer._ctx.profile())
                    elif path == "/spans":
                        spans_fn = getattr(outer._ctx, "spans", None)
                        if callable(spans_fn):
                            self._reply_json(200, spans_fn())
                        else:
                            self._reply_json(404, {
                                "error": "context has no spans() "
                                         "(causal span recorder "
                                         "unavailable)"})
                    elif path == "/flightrec":
                        self._reply_json(200, outer._ctx.flightrec())
                    elif path == "/fleet":
                        fleet_fn = getattr(outer._ctx, "fleet", None)
                        if callable(fleet_fn):
                            self._reply_json(200, fleet_fn())
                        else:
                            self._reply_json(404, {
                                "error": "context has no fleet() "
                                         "(fleet observability plane "
                                         "unavailable)"})
                    elif path == "/":
                        self._reply_json(200, {"routes": [
                            "/metrics", "/healthz", "/profile.json",
                            "/spans", "/flightrec", "/fleet",
                            "POST /flightrec/dump"]})
                    elif path == "/flightrec/dump":
                        self._reply_json(405, {"error":
                                               "use POST (guarded route)"})
                    else:
                        self._reply_json(404, {"error": "unknown route"})
                except Exception as exc:  # noqa: BLE001 - served as 500
                    self._reply_json(500, {"error": repr(exc)})

            def do_POST(self):  # noqa: N802 - http.server contract
                try:
                    parsed = urlparse(self.path)
                    if not self._authorized(parsed):
                        self._reply_json(
                            403, {"error": "bad or missing token"})
                        return
                    if parsed.path != "/flightrec/dump":
                        self._reply_json(404, {"error": "unknown route"})
                        return
                    directory = os.environ.get("TPUCOLL_FLIGHTREC_DIR",
                                               "flightrec-dump")
                    os.makedirs(directory, exist_ok=True)
                    # Mirror the native auto-dump naming: a split /
                    # epoch sub-context's dump carries its group tag
                    # ('/' -> '.', like flightrec.cc) so same-rank
                    # contexts sharing the directory never overwrite
                    # each other and merge_by_tag can partition.
                    tag_fn = getattr(outer._ctx, "group_tag", None)
                    tag = (tag_fn() if callable(tag_fn)
                           else "").replace("/", ".")
                    name = (f"flightrec-rank{outer._ctx.rank}"
                            + (f"-g{tag}" if tag else "") + ".json")
                    path = os.path.join(directory, name)
                    outer._ctx.flightrec_dump(path)
                    self._reply_json(200, {"path": path})
                except Exception as exc:  # noqa: BLE001 - served as 500
                    self._reply_json(500, {"error": repr(exc)})

        # SO_REUSEADDR explicitly: a restarting rank must be able to
        # rebind its fixed TPUCOLL_TELEMETRY_PORT while the previous
        # server's sockets sit in TIME_WAIT. http.server happens to
        # default this on; pinning it here makes the rebind contract
        # ours, not an inherited accident (regression-tested).
        class _Server(ThreadingHTTPServer):
            allow_reuse_address = True

        self._httpd = _Server((host, port), Handler)
        self._httpd.daemon_threads = True
        self._closed = False
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name=f"tpucoll-telemetry-{self._httpd.server_address[1]}",
            daemon=True)
        self._thread.start()

    @property
    def host(self) -> str:
        return self._httpd.server_address[0]

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def close(self) -> None:
        """Stop serving, close the listening socket, and JOIN the
        serving thread — after close() returns, the port is free to
        rebind. Idempotent: a second close is a no-op, not an error."""
        if self._closed:
            return
        self._closed = True
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def serve_telemetry(ctx, port: Optional[int] = None,
                    host: str = "127.0.0.1",
                    token: Optional[str] = None,
                    stall_window_ms: Optional[float] = None,
                    ) -> TelemetryServer:
    """Start the telemetry endpoint for ``ctx`` (see module docstring).

    ``port=None`` reads TPUCOLL_TELEMETRY_PORT (strict; unset -> 0 =
    ephemeral). ``token=None`` reads TPUCOLL_TELEMETRY_TOKEN; when
    either is set, POST /flightrec/dump requires it. Returns the
    running :class:`TelemetryServer` (``.port`` / ``.url`` / context
    manager)."""
    if port is None:
        port = _env_port()
    if token is None:
        token = os.environ.get("TPUCOLL_TELEMETRY_TOKEN") or None
    return TelemetryServer(ctx, host, port, token, stall_window_ms)
