"""HTTP endpoint (``bigdl_tpu/obs/endpoint.py``): ``/metrics``,
``/metrics.json`` and ``/healthz``.

One stdlib ``http.server`` thread serves a
:class:`~bigdl_tpu_torch.obs.registry.MetricsRegistry` as Prometheus text
and as JSON, and an aggregated health probe. Health checks are named
zero-argument callables, each returning a dict whose ``"ok"`` key
(default True) is the verdict; the endpoint is healthy when every check
is. :func:`engine_health` adapts a :class:`GenerationEngine` (a failed or
stalled engine refuses every submit: that is down). A check that raises
reports unhealthy with the error instead of breaking the probe.

``close()`` shuts the server down, joins its thread and releases the
socket: no ``bigdl-obs-endpoint`` thread survives it.
"""


from __future__ import annotations

import http.server
import json
import threading
from typing import Any, Callable, Dict, Optional, Tuple
from urllib.parse import urlsplit

from bigdl_tpu_torch.obs.exporters import to_json, to_prometheus
from bigdl_tpu_torch.obs.registry import MetricsRegistry

HealthCheck = Callable[[], Dict[str, Any]]


def engine_health(engine) -> HealthCheck:
    """Health adapter for a :class:`GenerationEngine`: healthy while no
    step failure/stall has stopped the loop (a stopped engine refuses
    every submit). Exposes the watchdog stall count as detail."""

    def check() -> Dict[str, Any]:
        failed = getattr(engine, "_failed", None)
        wd = getattr(engine, "_watchdog", None)
        return {"ok": failed is None,
                "error": None if failed is None
                else f"{type(failed).__name__}: {failed}",
                "watchdog_stalls": 0 if wd is None else wd.stalls}

    return check


class _Handler(http.server.BaseHTTPRequestHandler):
    # the endpoint instance is attached to the subclass per-server
    endpoint: "MetricsEndpoint"

    def do_GET(self):  # noqa: N802 (stdlib handler contract)
        path = urlsplit(self.path).path
        try:
            if path == "/metrics":
                body = to_prometheus(self.endpoint.registry.collect(),
                                     self.endpoint.prefix)
                self._reply(200, body,
                            "text/plain; version=0.0.4; charset=utf-8")
            elif path in ("/metrics.json", "/json"):
                body = to_json(self.endpoint.registry.collect())
                self._reply(200, body, "application/json")
            elif path == "/healthz":
                ok, detail = self.endpoint.health()
                self._reply(200 if ok else 503, json.dumps(detail),
                            "application/json")
            else:
                self._reply(404, json.dumps(
                    {"error": "not found",
                     "paths": ["/metrics", "/metrics.json", "/healthz"]}),
                    "application/json")
        except Exception as e:  # a broken collect must not kill the thread
            self._reply(500, json.dumps(
                {"error": f"{type(e).__name__}: {e}"}), "application/json")

    def _reply(self, code: int, body: str, ctype: str) -> None:
        data = body.encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def log_message(self, *args) -> None:  # scrapes are not log events
        pass


class MetricsEndpoint:
    """One background HTTP thread over a registry + health checks.

    ``port=0`` (the default) binds an ephemeral port — read it back
    from :attr:`port` / :meth:`url`. Binds loopback by default; pass
    ``host="0.0.0.0"`` deliberately to expose a fleet probe surface.
    """

    def __init__(self, registry: MetricsRegistry, *,
                 host: str = "127.0.0.1", port: int = 0,
                 health: Optional[Dict[str, HealthCheck]] = None,
                 prefix: str = "bigdl"):
        self.registry = registry
        self.prefix = prefix
        self._health: Dict[str, HealthCheck] = dict(health or {})
        self._lock = threading.Lock()
        self._closed = False
        handler = type("_BoundHandler", (_Handler,), {"endpoint": self})
        self._server = http.server.ThreadingHTTPServer((host, port),
                                                       handler)
        self._server.daemon_threads = True
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="bigdl-obs-endpoint",
            daemon=True)
        self._thread.start()

    # -------------------------------------------------------- health ----

    def add_health(self, name: str, check: HealthCheck) -> "MetricsEndpoint":
        """Register a named health check (chainable)."""
        with self._lock:
            self._health[name] = check
        return self

    def health(self) -> Tuple[bool, Dict[str, Any]]:
        """Aggregate verdict + per-check detail (what /healthz serves).
        No checks registered = healthy (a metrics-only endpoint)."""
        with self._lock:
            checks = list(self._health.items())
        detail: Dict[str, Any] = {}
        ok = True
        for name, check in checks:
            try:
                d = dict(check())
            except Exception as e:
                d = {"ok": False, "error": f"{type(e).__name__}: {e}"}
            d.setdefault("ok", True)
            ok = ok and bool(d["ok"])
            detail[name] = d
        return ok, {"ok": ok, "checks": detail}

    # ----------------------------------------------------- lifecycle ----

    @property
    def address(self) -> Tuple[str, int]:
        return self._server.server_address[:2]

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    def url(self, path: str = "/metrics") -> str:
        host, port = self.address
        return f"http://{host}:{port}{path}"

    def close(self, timeout: Optional[float] = 5.0) -> None:
        """Shut down, join the server thread, release the socket —
        idempotent, and no thread survives it (the drain-gate
        contract)."""
        if self._closed:
            return
        self._closed = True
        self._server.shutdown()
        self._thread.join(timeout)
        self._server.server_close()

    def __enter__(self) -> "MetricsEndpoint":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
