"""Telemetry export: Prometheus text exposition, JSON snapshots, HTTP serve.

``prometheus_text(snapshot)`` renders a :meth:`MetricsRegistry.snapshot`
in the Prometheus text exposition format (counters with ``_total`` names as
recorded, histograms as cumulative ``_bucket{le=...}`` series + ``_sum`` /
``_count``, gauges as-is).  ``start_metrics_server(port)`` serves it from a
daemon thread at ``/metrics`` (text) and ``/metrics.json`` (raw snapshot)
— the seam ``launch/serve_counts.py --metrics-port`` exposes.

Stdlib-only: the text for a given snapshot is byte for byte the JAX
package's.
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional


def _prom_labels(label_str: str, extra: str = "") -> str:
    parts = []
    if label_str:
        for kv in label_str.split(","):
            k, _, v = kv.partition("=")
            parts.append(f'{k}="{v}"')
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def _sanitize(name: str) -> str:
    return "".join(ch if (ch.isalnum() or ch == "_") else "_" for ch in name)


def prometheus_text(snapshot: dict) -> str:
    """Render a registry snapshot in Prometheus text exposition format."""
    out = []
    for name, sets in snapshot.get("counters", {}).items():
        pname = _sanitize(name)
        out.append(f"# TYPE {pname} counter")
        for ls, v in sets.items():
            out.append(f"{pname}{_prom_labels(ls)} {_num(v)}")
    for name, sets in snapshot.get("gauges", {}).items():
        pname = _sanitize(name)
        out.append(f"# TYPE {pname} gauge")
        for ls, v in sets.items():
            out.append(f"{pname}{_prom_labels(ls)} {_num(v)}")
    for name, sets in snapshot.get("histograms", {}).items():
        pname = _sanitize(name)
        out.append(f"# TYPE {pname} histogram")
        for ls, h in sets.items():
            cum = 0
            for ub, c in zip(h["buckets"], h["counts"]):
                cum += c
                le = 'le="%s"' % _num(ub)
                out.append(f"{pname}_bucket{_prom_labels(ls, le)} {cum}")
            inf = 'le="+Inf"'
            out.append(f"{pname}_bucket{_prom_labels(ls, inf)} {h['count']}")
            out.append(f"{pname}_sum{_prom_labels(ls)} {_num(h['sum'])}")
            out.append(f"{pname}_count{_prom_labels(ls)} {h['count']}")
    return "\n".join(out) + "\n"


def _num(v) -> str:
    if isinstance(v, float) and v.is_integer():
        return str(int(v))
    return str(v)


class _MetricsHandler(BaseHTTPRequestHandler):
    registry = None   # class attr bound by start_metrics_server

    def do_GET(self):   # noqa: N802 (http.server API)
        snap = self.registry.snapshot()
        if self.path.startswith("/metrics.json"):
            body = json.dumps(snap, indent=1).encode()
            ctype = "application/json"
        elif self.path.startswith("/metrics") or self.path == "/":
            body = prometheus_text(snap).encode()
            ctype = "text/plain; version=0.0.4"
        else:
            self.send_error(404)
            return
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *a):   # silence per-request stderr noise
        return None


def start_metrics_server(port: int,
                         registry=None) -> ThreadingHTTPServer:
    """Serve ``/metrics`` (Prometheus text) and ``/metrics.json`` from a
    daemon thread; returns the server (``.shutdown()`` to stop).  ``port=0``
    binds an ephemeral port (``server.server_address[1]``)."""
    if registry is None:
        from . import REGISTRY
        registry = REGISTRY
    handler = type("Handler", (_MetricsHandler,), {"registry": registry})
    srv = ThreadingHTTPServer(("127.0.0.1", port), handler)
    threading.Thread(target=srv.serve_forever, daemon=True,
                     name="metrics-http").start()
    return srv


def dump_json(path: str, snapshot: dict,
              extra: Optional[dict] = None) -> None:
    """Write a snapshot (plus optional extra sections) as indented JSON."""
    doc = dict(snapshot)
    if extra:
        doc.update(extra)
    with open(path, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")
