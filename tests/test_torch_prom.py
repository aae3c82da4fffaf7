"""The port's Prometheus exposition and stage reports against the JAX
package's.

Mirrors the exposition and endpoint cases of tests/test_obs.py: a render
that lints clean (with the port's linter and with tests/prom_lint.py, the
reference's), a linter that rejects malformed text, and the ``/metrics``
HTTP endpoint; the same registry content renders to the same text in both
packages.
"""
import json
import urllib.error
import urllib.request

import pytest

import repro_torch.obs as obs


@pytest.fixture()
def clean_obs():
    """Isolate the global obs state; leave obs disabled and empty after."""
    prev = obs.enabled()
    obs.disable()
    obs.reset()
    yield
    obs.enable() if prev else obs.disable()
    obs.reset()


def record(o):
    o.counter("repro_t_total", 2.0, path="a b")   # label value with space
    o.counter("repro_t_total", 1.0, path='quote"back\\slash\nnl')
    o.gauge("repro_t", -1.5)
    o.gauge("repro_t_big", 1e20)
    o.observe("repro_t_seconds", 0.02)
    o.observe("repro_t_seconds", 3.5, stage="x")
    o.fallback("warm_torch", "warm_numpy", "ValueError")


def test_prometheus_render_lints_clean(clean_obs, tmp_path):
    obs.enable()
    record(obs)
    text = obs.render_prometheus()
    assert obs.lint_exposition(text) == []
    assert '# TYPE repro_t_seconds histogram' in text
    assert 'le="+Inf"' in text
    prom = obs.write_textfile(tmp_path / "sub" / "metrics.prom")
    assert prom.read_text() == text
    import prom_lint
    assert prom_lint.check_file(str(prom), ["repro_t_total=2",
                                            "repro_fallbacks_total"]) == []


def test_render_matches_reference(clean_obs):
    """The same records render to the same exposition text."""
    import repro.obs as ref_obs
    prev = ref_obs.enabled()
    ref_obs.enable()
    ref_obs.reset()
    try:
        record(ref_obs)
        want = ref_obs.render_prometheus()
    finally:
        ref_obs.reset()
        ref_obs.enable() if prev else ref_obs.disable()
    obs.enable()
    record(obs)
    assert obs.render_prometheus() == want
    assert obs.render_prometheus(obs.MetricsRegistry()) == ""


def test_linter_rejects_malformed_expositions():
    assert obs.lint_exposition("repro_x 1\n")       # sample before TYPE
    assert obs.lint_exposition("# TYPE repro_x counter\nrepro_x one\n")
    assert obs.lint_exposition("# TYPE repro_x gauge\n# TYPE repro_x gauge\n")
    assert obs.lint_exposition(
        "# TYPE repro_x histogram\n"
        'repro_x_bucket{le="1"} 1\n'                # no +Inf bucket
        "repro_x_count 1\n")
    assert obs.lint_exposition(
        "# TYPE repro_x histogram\n"
        'repro_x_bucket{le="+Inf"} 1\n'
        "repro_x_count 2\n")                        # +Inf != _count
    assert obs.lint_exposition("# TYPE repro_x counter\nrepro_x{bad} 1\n")


def test_http_metrics_endpoint(clean_obs):
    obs.enable()
    obs.counter("repro_http_total", 3.0)
    server = obs.start_http_server(port=0)
    try:
        port = server.server_address[1]
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/metrics") as resp:
            assert resp.status == 200
            assert resp.headers["Content-Type"].startswith("text/plain")
            body = resp.read().decode()
        assert "repro_http_total 3" in body
        assert obs.lint_exposition(body) == []
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(f"http://127.0.0.1:{port}/nope")
    finally:
        server.shutdown()


def test_stage_breakdown_and_report(clean_obs):
    obs.enable()
    with obs.span("live.tick", tick=0):
        with obs.span("whatif.search"):
            pass
        with obs.span("whatif.search"):
            pass
    obs.counter("repro_live_ticks_total", result="refreshed")
    breakdown = obs.stage_breakdown()
    assert breakdown["n_spans"] == 3
    assert breakdown["stages"]["whatif.search"]["count"] == 2
    assert list(breakdown["stages"])[0] == "live.tick"   # by total time
    json.dumps(breakdown)                                 # JSON-able
    report = obs.stage_report()
    assert "live.tick" in report and "whatif.search" in report
    assert report.endswith("[obs] 1 metric families recorded")
    obs.reset()
    assert obs.stage_report() == "[obs] 0 metric families recorded"
