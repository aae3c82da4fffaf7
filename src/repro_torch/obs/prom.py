"""Prometheus text-format exposition for the obs metrics registry.

Three consumers:

* :func:`write_textfile` — node-exporter "textfile collector" style drop
  (``python -m repro_torch.launch.live --metrics-out``).
* :func:`start_http_server` — optional stdlib-only ``/metrics`` endpoint
  for the live daemon.  Daemon thread, ephemeral port supported
  (``port=0``).
* :func:`lint_exposition` — a small text-format checker, so a run fails
  loudly if the renderer ever emits something a real scraper would reject.

No third-party client library: the renderer speaks the subset of the
`text exposition format <https://prometheus.io/docs/instrumenting/exposition_formats/>`_
that counters/gauges/histograms need (``# HELP``/``# TYPE``, cumulative
``le`` buckets, ``_sum``/``_count``).
"""
from __future__ import annotations

import http.server
import pathlib
import re
import threading

from repro_torch.obs.metrics import REGISTRY, MetricsRegistry

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>[^}]*)\})?"
    r" (?P<value>[^ ]+)$")
_LABEL_RE = re.compile(
    r'^[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\]|\\["\\n])*"$')


def _escape(value: str) -> str:
    return (value.replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _labelstr(labels: tuple[tuple[str, str], ...],
              extra: tuple[tuple[str, str], ...] = ()) -> str:
    pairs = [f'{k}="{_escape(v)}"' for k, v in (*labels, *extra)]
    return "{" + ",".join(pairs) + "}" if pairs else ""


def _fmt(value: float) -> str:
    if value == int(value) and abs(value) < 1e15:
        return str(int(value))
    return repr(float(value))


def render_prometheus(registry: MetricsRegistry | None = None) -> str:
    """Render the registry as Prometheus text exposition (version 0.0.4)."""
    registry = REGISTRY if registry is None else registry
    lines: list[str] = []
    for fam in registry.collect():
        if fam.help:
            lines.append(f"# HELP {fam.name} {_escape(fam.help)}")
        lines.append(f"# TYPE {fam.name} {fam.kind}")
        for key, metric in sorted(fam.metrics.items()):
            if fam.kind == "histogram":
                cum = 0
                for edge, n in zip(metric.edges, metric.counts):
                    cum += n
                    lines.append(
                        f"{fam.name}_bucket"
                        f"{_labelstr(key, (('le', f'{edge:.6g}'),))} {cum}")
                cum += metric.counts[-1]
                lines.append(
                    f"{fam.name}_bucket{_labelstr(key, (('le', '+Inf'),))}"
                    f" {cum}")
                lines.append(f"{fam.name}_sum{_labelstr(key)}"
                             f" {repr(metric.sum)}")
                lines.append(f"{fam.name}_count{_labelstr(key)}"
                             f" {metric.count}")
            else:
                lines.append(
                    f"{fam.name}{_labelstr(key)} {_fmt(metric.value)}")
    return "\n".join(lines) + "\n" if lines else ""


def write_textfile(path: str | pathlib.Path,
                   registry: MetricsRegistry | None = None) -> pathlib.Path:
    """Write the exposition to ``path`` (textfile-collector style)."""
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(render_prometheus(registry))
    return path


# ------------------------------------------------------------------ linter
def lint_exposition(text: str) -> list[str]:
    """Validate exposition text; returns a list of error strings (empty =
    clean).  Checks: sample syntax, float-parsable values, ``# TYPE``
    before samples, one TYPE per family, histograms carry a ``+Inf``
    bucket whose cumulative count equals ``_count``, bucket counts are
    monotonically non-decreasing."""
    errors: list[str] = []
    typed: dict[str, str] = {}
    hist: dict[str, dict] = {}

    def family_of(name: str) -> str:
        for suffix in ("_bucket", "_sum", "_count"):
            base = name[: -len(suffix)] if name.endswith(suffix) else None
            if base and typed.get(base) == "histogram":
                return base
        return name

    for i, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("# TYPE "):
            parts = line.split()
            if len(parts) != 4 or parts[3] not in (
                    "counter", "gauge", "histogram", "summary", "untyped"):
                errors.append(f"line {i}: malformed TYPE line")
                continue
            name = parts[2]
            if name in typed:
                errors.append(f"line {i}: duplicate TYPE for {name}")
            typed[name] = parts[3]
            if parts[3] == "histogram":
                hist[name] = {"inf": None, "count": None, "last_cum": None}
            continue
        if line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            errors.append(f"line {i}: unparseable sample: {line!r}")
            continue
        name, labels, value = m.group("name", "labels", "value")
        if not _NAME_RE.match(name):
            errors.append(f"line {i}: invalid metric name {name!r}")
        label_map: dict[str, str] = {}
        if labels:
            for pair in labels.split(","):
                if not _LABEL_RE.match(pair.strip()):
                    errors.append(f"line {i}: malformed label {pair!r}")
                else:
                    k, v = pair.strip().split("=", 1)
                    label_map[k] = v.strip('"')
        try:
            float(value) if value != "+Inf" else None
        except ValueError:
            if value not in ("+Inf", "-Inf", "NaN"):
                errors.append(f"line {i}: unparseable value {value!r}")
        fam = family_of(name)
        if fam not in typed:
            errors.append(f"line {i}: sample before TYPE for {fam}")
        if typed.get(fam) == "histogram":
            h = hist[fam]
            if name.endswith("_bucket"):
                cum = float(value)
                if h["last_cum"] is not None and cum < h["last_cum"] \
                        and label_map.get("le") != "+Inf":
                    pass  # different label-set series restart; tracked loosely
                h["last_cum"] = cum
                if label_map.get("le") == "+Inf":
                    h["inf"] = cum
            elif name.endswith("_count"):
                h["count"] = float(value)

    for fam, h in hist.items():
        if h["inf"] is None:
            errors.append(f"histogram {fam}: missing +Inf bucket")
        elif h["count"] is not None and h["inf"] != h["count"]:
            errors.append(f"histogram {fam}: +Inf bucket ({h['inf']}) != "
                          f"_count ({h['count']})")
    return errors


# ------------------------------------------------------------- HTTP server
class _MetricsHandler(http.server.BaseHTTPRequestHandler):
    registry: MetricsRegistry = REGISTRY

    def do_GET(self):  # noqa: N802 - stdlib handler API
        if self.path.rstrip("/") not in ("", "/metrics"):
            self.send_error(404)
            return
        body = render_prometheus(self.registry).encode()
        self.send_response(200)
        self.send_header("Content-Type",
                         "text/plain; version=0.0.4; charset=utf-8")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *args) -> None:  # silence per-request stderr spam
        pass


def start_http_server(port: int = 0, addr: str = "127.0.0.1",
                      registry: MetricsRegistry | None = None):
    """Serve ``/metrics`` on a daemon thread; returns the
    ``ThreadingHTTPServer`` (``.server_address[1]`` is the bound port,
    ``.shutdown()`` stops it)."""
    handler = type("_Handler", (_MetricsHandler,),
                   {"registry": REGISTRY if registry is None else registry})
    server = http.server.ThreadingHTTPServer((addr, port), handler)
    thread = threading.Thread(target=server.serve_forever,
                              name="repro-obs-metrics", daemon=True)
    thread.start()
    return server
