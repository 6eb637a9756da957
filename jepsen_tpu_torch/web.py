"""Web interface: a minimal HTTP server for browsing the store directory
(reference jepsen/src/jepsen/web.clj), grown into the fleet's
submission API (the port's copy of ``jepsen_tpu/web.py``).

Home page lists tests with validity-colored rows (web.clj:104-134); test
directories are browsable with file streaming and whole-dir zip download
(web.clj:262-303), with a path-traversal guard (web.clj:304-309).

The ``/api/`` routes turn the viewer into checking-as-a-service
(``fleet/service.py`` holds the request logic)::

    POST /api/check           history JSON -> verdict
    POST /api/campaigns       sweep matrix -> campaign id (202)
    GET  /api/campaigns       submitted/stored campaign ids
    GET  /api/campaigns/<id>  pollable status + records
    GET  /api/metrics         live Prometheus text exposition

The service Coalescer ``serve`` brings up batches more than /api/check
tenants: campaigns run on this server with a streamlin monitor route
their per-chunk frontier folds through the same batcher, one lane per
model (``streamlin:<model>``), so monitored streams share lane-batched
folds with the API traffic (per-stream deadlines; a stopped coalescer
hands its folds to the solo path). The lanes are observable on
/api/metrics as ``jepsen_service_coalesce_*`` series with
``model="streamlin:..."`` labels.

``serve`` takes the service's device once (``device``, None: CUDA):
the coalescer's batches and every solo search run there. Its
``capacity-plan`` option pre-registers a capacity plan's predicted
(model, bucket) shapes on the coalescer.

API transport hardening lives here: request bodies are refused (413)
when Content-Length exceeds ``service.MAX_BODY_BYTES`` -- BEFORE any
read, so an adversarial body can't balloon memory -- reads are bounded
to the declared length, and every /api/* error (400/404/405/411/413)
is a JSON object, never an HTML page.
"""

from __future__ import annotations

import html
import io
import json
import logging
import os
import threading
import urllib.parse
import zipfile
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from . import store
from .obs.metrics import parse_flat_key

logger = logging.getLogger(__name__)

STYLE = """
body { font-family: sans-serif; margin: 2em; }
table { border-collapse: collapse; }
td, th { padding: 4px 12px; text-align: left; }
tr.valid-true { background: #ADF6B0; }
tr.valid-false { background: #F6B5AD; }
tr.valid-unknown { background: #F3F6AD; }
a { text-decoration: none; }
"""


def _valid_class(valid):
    if valid is True:
        return "valid-true"
    if valid is False:
        return "valid-false"
    return "valid-unknown"


def _monitor_header(path):
    """The monitor.json verdict header for a run dir, or None."""
    try:
        with open(path) as f:
            mv = json.load(f)
    except (OSError, json.JSONDecodeError):
        return None
    if not isinstance(mv, dict):
        return None
    return {"verdict": mv.get("verdict"),
            "index": mv.get("detected_at_index"),
            "latency": mv.get("detection_latency_s")}


def _monitor_cell(mon):
    """Render the home-table monitor column for one run."""
    if mon is None:
        return ""
    if mon["verdict"] is False:
        return (f"violation @{html.escape(str(mon['index']))} "
                f"({html.escape(str(mon['latency']))}s)")
    return html.escape(str(mon["verdict"]))


def _fast_tests():
    """Test rows from results.json headers only (web.clj:48-69), plus
    which observability/analysis artifacts each run has on disk and
    the streaming monitor's verdict when the run was monitored."""
    rows = []
    for name in store.test_names():
        for t in sorted(store.tests(name), reverse=True):
            valid = None
            try:
                r = store.load_results(name, t)
                valid = r.get("valid") if isinstance(r, dict) else None
            except (FileNotFoundError, json.JSONDecodeError):
                valid = "incomplete"
            fake = {"name": name, "start-time": t}
            # profile.json is the profiler capture's marker
            # (obs/profile.py), written next to trace.jsonl when a
            # run was profiled — linked like the other artifacts
            # certificate.json is the proof-carrying verdict
            # (analysis/certify.py): the witness replayed + checks
            # run, re-certifiable offline (certify.certify_run)
            obs_files = [f for f in ("metrics.json", "analysis.json",
                                     "monitor.json", "profile.json",
                                     "certificate.json")
                         if os.path.exists(store.path(fake, f))]
            mon = _monitor_header(store.path(fake, "monitor.json")) \
                if "monitor.json" in obs_files else None
            # the Trace column: the finalized trace, or the crash-safe
            # journal a kill -9'd run left behind (exactly the run
            # whose trace matters most)
            trace = next(
                (f for f in ("trace.jsonl", store.TRACE_JOURNAL_FILE)
                 if os.path.exists(store.path(fake, f))), None)
            rows.append({"name": name, "time": t, "valid": valid,
                         "obs": obs_files, "monitor": mon,
                         "trace": trace})
    rows.sort(key=lambda r: r["time"], reverse=True)
    return rows


def _home_page():
    rows = []
    for t in _fast_tests():
        link = f"/files/{urllib.parse.quote(t['name'])}/" \
               f"{urllib.parse.quote(t['time'])}/"
        zip_link = link.rstrip("/") + ".zip"
        obs_links = " ".join(
            f'<a href="{link}{f}">{html.escape(f.split(".")[0])}</a>'
            for f in t.get("obs", ()))
        trace = t.get("trace")
        trace_cell = "" if trace is None else (
            f'<a href="{link}{trace}">'
            f'{"journal" if trace.endswith(".journal") else "trace"}'
            "</a>")
        rows.append(
            f'<tr class="{_valid_class(t["valid"])}">'
            f'<td>{html.escape(t["name"])}</td>'
            f'<td><a href="{link}">{html.escape(t["time"])}</a></td>'
            f'<td>{html.escape(str(t["valid"]))}</td>'
            f'<td>{_monitor_cell(t.get("monitor"))}</td>'
            f'<td>{trace_cell}</td>'
            f'<td>{obs_links}</td>'
            f'<td><a href="{zip_link}">zip</a></td></tr>')
    return f"""<html><head><style>{STYLE}</style>
<title>Jepsen</title></head><body>
<h1>Jepsen</h1>
<p><a href="/campaigns">Campaigns</a></p>
<table><thead><tr><th>Test</th><th>Time</th><th>Valid?</th>
<th>Monitor</th><th>Trace</th><th>Observability</th><th></th>
</tr></thead><tbody>{''.join(rows)}</tbody></table></body></html>"""


def _run_link(path):
    """A /files link for a recorded store path (campaign records store
    paths relative to the working directory, base_dir-prefixed)."""
    if not path:
        return ""
    rel = os.path.relpath(str(path), store.base_dir)
    if rel.startswith(".."):
        return ""
    return f"/files/{urllib.parse.quote(rel)}/"


def _campaign_cell_class(outcome):
    if outcome is True:
        return "valid-true"
    if outcome is False or outcome == "crashed":
        return "valid-false"
    return "valid-unknown"


#: the shared flattened-metrics-key parser (one definition for every
#: consumer)
_flat_key = parse_flat_key


def _utilization_rows(cid, records):
    """Per-worker utilization for one campaign: cells run / wall
    seconds from the cell records, steal counts and sync failures from
    the campaign's merged metrics (metrics.json, falling back to the
    crash-safe journal while the campaign is still live)."""
    per = {}

    def row(w):
        return per.setdefault(str(w), {"cells": 0, "wall_s": 0.0,
                                       "steals": 0, "sync_failures": 0})

    for r in records:
        st = row(r.get("worker") or "local")
        st["cells"] += 1
        st["wall_s"] += float(r.get("wall_s") or 0.0)
    metrics = store.load_run_metrics(store.campaign_path(cid)) or {}
    for k, v in (metrics.get("counters") or {}).items():
        name, labels = _flat_key(k)
        w = labels.get("worker")
        if not w:
            continue
        if name == "fleet.cells_stolen":
            row(w)["steals"] += int(v)
        elif name == "fleet.artifact_syncs" \
                and labels.get("status") == "failed":
            row(w)["sync_failures"] += int(v)
    return per


def _audit_header(cid):
    """The persisted fleetlint report's headline (counts), or None
    when the campaign was never audited."""
    from .analysis import fleetlint
    fa = fleetlint.load_report(cid)
    return fa if isinstance(fa, dict) else None


def _capacity_table(data):
    """The predicted-vs-actual compile-shape table for a
    capacity-planned campaign (report.json["capacity"], written by
    the capplan prediction oracle at finalize), or "" when the
    campaign was never planned."""
    cap = ((data or {}).get("report") or {}).get("capacity") or {}
    oracle = cap.get("oracle")
    if not oracle:
        return ""
    pred = {tuple(k) for k in oracle.get("predicted") or []}
    act = {tuple(k) for k in oracle.get("actual") or []}
    rows = []
    for m, b in sorted(pred | act):
        rows.append(
            f"<tr><td>{html.escape(str(m))}</td><td>{b}</td>"
            f"<td>{'yes' if (m, b) in pred else 'no'}</td>"
            f"<td>{'yes' if (m, b) in act else 'no'}</td></tr>")
    err = oracle.get("error_frac")
    return (
        "<h3>Capacity: predicted vs actual compile shapes</h3>"
        f"<p>prediction error: {err if err is not None else '?'}"
        + (f" &mdash; recommendation: set_n_floor("
           f"{cap['recommendation']['set_n_floor']})"
           if cap.get("recommendation") else "") + "</p>"
        "<table><thead><tr><th>Model</th><th>Bucket</th>"
        "<th>Predicted</th><th>Actual</th></tr></thead>"
        f"<tbody>{''.join(rows)}</tbody></table>")


def _waste_table(cid):
    """The padding-waste table (per n-bucket real vs padded
    rows) from the campaign's metrics fold, rendered next to the
    capacity table so predicted shapes and measured padding read
    side by side; "" when the campaign has no fold."""
    try:
        with open(store.campaign_path(cid, "metrics_fold.json")) as f:
            fold = json.load(f)
        from .obs.merge import introspection_summary
        padding = (introspection_summary(fold) or {}).get("padding")
    except Exception:  # noqa: BLE001 - the page must render
        return ""
    if not padding:
        return ""
    rows = "".join(
        f"<tr><td>{html.escape(str(b))}</td><td>{st['real']}</td>"
        f"<td>{st['padded']}</td>"
        f"<td>{st['waste_frac'] * 100:.1f}%</td></tr>"
        for b, st in padding.items())
    return ("<h3>Padding waste (per n-bucket)</h3>"
            "<table><thead><tr><th>Bucket</th><th>Real</th>"
            "<th>Padded</th><th>Waste</th></tr></thead>"
            f"<tbody>{rows}</tbody></table>")


def _phase_rows_html(summary):
    """Per-engine phase-breakdown table rows from an
    introspection_summary dict; "" when no phase accounting exists."""
    phase_s = (summary or {}).get("phase_s")
    if not phase_s:
        return ""
    rows = []
    for eng, per in sorted(phase_s.items()):
        total = sum(per.values()) or 1.0
        for p, s in sorted(per.items(), key=lambda kv: -kv[1]):
            rows.append(
                f"<tr><td>{html.escape(eng)}</td>"
                f"<td>{html.escape(p)}</td><td>{s:.3f}</td>"
                f"<td>{s / total * 100:.1f}%</td></tr>")
    return ("<h3>Where the time goes (per-dispatch phases)</h3>"
            "<table><thead><tr><th>Engine</th><th>Phase</th>"
            "<th>Seconds</th><th>Share</th></tr></thead>"
            f"<tbody>{''.join(rows)}</tbody></table>")


def _phase_table(cid):
    """The campaign's phase-breakdown table (obs.phases attribution
    folded across cells) plus the bubble-ledger headline when
    finalize wrote one; "" when the campaign has neither."""
    out = ""
    try:
        with open(store.campaign_path(cid, "metrics_fold.json")) as f:
            fold = json.load(f)
        from .obs.merge import introspection_summary
        out += _phase_rows_html(introspection_summary(fold))
    except Exception:  # noqa: BLE001 - the page must render
        pass
    try:
        with open(store.campaign_path(cid, "bubble_ledger.json")) as f:
            led = json.load(f)
        if led.get("episodes"):
            out += (
                "<p>idle bubbles: "
                f"{led.get('device_s', 0.0):.3f}s device-compute, "
                f"{led.get('idle_s', 0.0):.3f}s idle, "
                f"{led.get('attribution_frac', 0.0) * 100:.1f}% "
                "attributed &mdash; "
                f'<a href="/files/{store.CAMPAIGNS_DIR}/'
                f'{urllib.parse.quote(cid)}/bubble_ledger.json">'
                "bubble_ledger.json</a></p>")
    except Exception:  # noqa: BLE001 - the page must render
        pass
    return out


def _campaigns_page():
    """Campaign index: one section per campaign, its runs grouped by
    cell (web's view of store/campaigns/<id>/). Fleet campaigns
    additionally link the merged ``campaign_trace.jsonl`` (one
    Perfetto timeline, one lane per worker, clocks normalized) and
    render the per-worker utilization table."""
    sections = []
    for cid in sorted(store.campaigns(), reverse=True):
        data = store.load_campaign(cid)
        if data is None:
            continue
        meta = data["meta"]
        # latest record per cell (a resumed campaign's journal keeps
        # superseded "aborted" rows): store's shared fold
        records = store.latest_campaign_records(cid)
        counts = {}
        for r in records:
            k = str(r.get("outcome"))
            counts[k] = counts.get(k, 0) + 1
        badge = ", ".join(f"{k}: {v}" for k, v in sorted(counts.items()))
        rows = []
        for r in records:
            link = _run_link(r.get("path"))
            path_cell = (f'<a href="{link}">'
                         f'{html.escape(str(r.get("path")))}</a>'
                         if link else html.escape(str(r.get("path"))))
            rows.append(
                f'<tr class="{_campaign_cell_class(r.get("outcome"))}">'
                f'<td>{html.escape(str(r.get("cell")))}</td>'
                f'<td>{html.escape(str(r.get("outcome")))}</td>'
                f'<td>{html.escape(str(r.get("valid")))}</td>'
                f'<td>{path_cell}</td>'
                f'<td>{html.escape(str(r.get("wall_s", "")))}</td>'
                f"</tr>")
        planned = len(meta.get("cells") or [])
        files = f"/files/{store.CAMPAIGNS_DIR}/{urllib.parse.quote(cid)}/"
        # the control-plane audit verdict (analysis.fleetlint, written
        # at fleet finalize): clean / N errors, linked to the full
        # fleet_analysis.json report
        audit_line = ""
        fa = _audit_header(cid)
        if fa is not None:
            c = fa.get("counts") or {}
            verdict = "clean" if not c.get("error") else (
                f"{c.get('error', 0)} error(s), "
                f"{c.get('warning', 0)} warning(s)")
            audit_line = (f' &mdash; audit: <a href="{files}'
                          f'fleet_analysis.json">'
                          f"{html.escape(verdict)}</a>")
        trace_link = ""
        if os.path.exists(store.campaign_path(cid,
                                              "campaign_trace.jsonl")):
            trace_link = (f' &mdash; <a href="{files}'
                          'campaign_trace.jsonl">merged trace</a>')
        capacity_link = ""
        if os.path.exists(store.campaign_path(cid,
                                              "capacity_plan.json")):
            capacity_link = (f' &mdash; <a href="{files}'
                             'capacity_plan.json">capacity plan</a>')
        util = _utilization_rows(cid, records)
        util_table = ""
        if util:
            urows = "".join(
                f"<tr><td>{html.escape(w)}</td>"
                f"<td>{st['cells']}</td>"
                f"<td>{st['wall_s']:.1f}</td>"
                f"<td>{st['steals']}</td>"
                f"<td>{st['sync_failures']}</td></tr>"
                for w, st in sorted(util.items()))
            util_table = (
                "<table><thead><tr><th>Worker</th><th>Cells</th>"
                "<th>Wall (s)</th><th>Steals</th>"
                "<th>Sync failures</th></tr></thead>"
                f"<tbody>{urows}</tbody></table>")
        sections.append(
            f'<h2><a href="{files}">{html.escape(cid)}</a></h2>'
            f"<p>status: {html.escape(str(meta.get('status')))} &mdash; "
            f"{len(records)}/{planned} cells ({html.escape(badge)})"
            f"{audit_line}{trace_link}{capacity_link}</p>{util_table}"
            f"{_capacity_table(data)}{_waste_table(cid)}"
            f"{_phase_table(cid)}"
            f"<table><thead><tr><th>Cell</th><th>Outcome</th>"
            f"<th>Valid?</th><th>Run</th><th>Wall (s)</th></tr></thead>"
            f"<tbody>{''.join(rows)}</tbody></table>")
    body = "".join(sections) or "<p>No campaigns yet.</p>"
    return f"""<html><head><style>{STYLE}</style>
<title>Jepsen campaigns</title></head><body>
<h1>Campaigns</h1><p><a href="/">&larr; tests</a></p>
{body}</body></html>"""


def _dir_page(rel, full):
    entries = sorted(os.listdir(full))
    items = []
    for e in entries:
        p = os.path.join(full, e)
        slash = "/" if os.path.isdir(p) else ""
        items.append(f'<li><a href="{urllib.parse.quote(e)}{slash}">'
                     f"{html.escape(e)}{slash}</a></li>")
    # per-run monitor banner: a monitored run's verdict + detection
    # index belong on the page, not just inside monitor.json
    banner = ""
    mon = _monitor_header(os.path.join(full, "monitor.json")) \
        if "monitor.json" in entries else None
    if mon is not None:
        if mon["verdict"] is False:
            banner = (f"<p><b>monitor: violation</b> at history index "
                      f"{html.escape(str(mon['index']))}, detected "
                      f"{html.escape(str(mon['latency']))}s after the "
                      f"op landed</p>")
        else:
            banner = (f"<p>monitor: {html.escape(str(mon['verdict']))}"
                      "</p>")
    # per-run phase breakdown: a run dir with metrics.json gets the
    # same where-the-time-goes table the campaign page renders
    phase_panel = ""
    if "metrics.json" in entries:
        try:
            with open(os.path.join(full, "metrics.json")) as f:
                m = json.load(f)
            from .obs.merge import introspection_summary
            phase_panel = _phase_rows_html(introspection_summary(m))
        except Exception:  # noqa: BLE001 - the page must render
            pass
    return f"""<html><head><style>{STYLE}</style></head><body>
<h1>/{html.escape(rel)}</h1>{banner}{phase_panel}<ul>{''.join(items)}</ul>
</body></html>"""


def _zip_dir(full):
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as z:
        for root, _dirs, files in os.walk(full):
            for f in files:
                p = os.path.join(root, f)
                z.write(p, os.path.relpath(p, os.path.dirname(full)))
    return buf.getvalue()


class Server(ThreadingHTTPServer):
    """The viewer's and the service's listener. Its accept queue holds a
    burst of clients (socketserver's default holds 5): the admission
    gate answers each request past its budget with a 429, which an
    overflowing queue can turn into a reset connection while the accept
    loop waits for the interpreter behind a running check."""

    request_queue_size = 128


class Handler(BaseHTTPRequestHandler):
    def log_message(self, fmt, *args):  # quiet
        logger.debug("web: " + fmt, *args)

    def _send(self, code, body, ctype="text/html; charset=utf-8",
              headers=None):
        # remembered for the /api SLO accounting in _api's finally
        self._last_code = code
        if isinstance(body, str):
            body = body.encode()
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, code, obj, headers=None):
        return self._send(code, json.dumps(obj, cls=store._Encoder),
                          "application/json; charset=utf-8",
                          headers=headers)

    def _read_json_body(self):
        """Bounded request-body read: the declared Content-Length is
        validated BEFORE any byte is read, so an oversized body gets a
        413 instead of an OOM read, and the read itself never exceeds
        the declared length."""
        from .fleet.service import ApiError, MAX_BODY_BYTES
        cl = self.headers.get("Content-Length")
        if cl is None:
            raise ApiError(411, "Content-Length required")
        try:
            n = int(cl)
        except (TypeError, ValueError):
            raise ApiError(400, f"bad Content-Length {cl!r}") from None
        if n < 0:
            raise ApiError(400, f"bad Content-Length {cl!r}")
        if n > MAX_BODY_BYTES:
            # don't read a byte of it; drop the connection after
            # responding so the still-sending client can't wedge us
            self.close_connection = True
            raise ApiError(413, f"request body of {n} bytes exceeds "
                                f"the {MAX_BODY_BYTES}-byte limit")
        body = self.rfile.read(n)
        try:
            return json.loads(body)
        except ValueError:
            raise ApiError(400, "request body is not valid JSON") \
                from None

    def _caller(self):
        """Authorize this request, whatever the route. With tokens
        configured the token may arrive as ``Authorization: Bearer``
        or ``?token=`` (browsers can't set headers); without tokens
        the client address identifies the caller. Raises
        service.ApiError(401) on a bad/missing token."""
        from .fleet import service
        q = urllib.parse.parse_qs(urllib.parse.urlparse(self.path).query)
        header = self.headers.get("Authorization") \
            or (q.get("token") or [None])[0]
        return service.authorize(
            header, client=(self.client_address or ("local",))[0])

    def _gate_html(self):
        """Authn for the HTML/file routes: the store's histories and
        verdicts (and the on-demand scp pull a /files miss can
        trigger) are exactly what the token protects, so a token-
        configured service gates EVERY route, not just /api. Sends
        the error response and returns True when the request is
        rejected (the caller must STOP -- writing the page after the
        401 would leak it on the same socket), else False."""
        from .fleet import service
        try:
            self._caller()
            return False
        except service.ApiError as e:
            self._send_json(e.status, e.payload, headers=e.headers)
            return True

    def _api(self, method, path):
        """The /api/* routes: JSON in, JSON out, JSON errors. Every
        route passes the admission gate first -- token authn (401),
        then per-caller budgets (429 + Retry-After) -- so rejected
        traffic never reaches the request logic, let alone in-flight
        campaigns. Every response — success or 4xx/5xx — lands in the
        service SLO registry (per-endpoint request counts + latency
        histograms) via ``service.note_request``."""
        from .fleet import service
        import time as _time
        t0 = _time.monotonic()
        self._last_code = None
        try:
            return self._api_routed(method, path, service)
        finally:
            if self._last_code is not None:
                service.note_request(service.endpoint_of(path),
                                     self._last_code,
                                     _time.monotonic() - t0)

    def _api_routed(self, method, path, service):
        try:
            caller = self._caller()
            clean = path.rstrip("/")
            if clean == "/api/check":
                if method != "POST":
                    raise service.ApiError(
                        405, "POST a {'history': [...]} body here")
                return self._send_json(
                    200, service.check_history(self._read_json_body(),
                                               caller=caller))
            if clean == "/api/campaigns":
                if method == "POST":
                    _cid, meta = service.submit_campaign(
                        self._read_json_body(), caller=caller)
                    return self._send_json(202, meta)
                if method != "GET":
                    raise service.ApiError(405, "GET or POST only")
                return self._send_json(200,
                                       {"campaigns": store.campaigns()})
            if clean.startswith("/api/campaigns/"):
                if method != "GET":
                    raise service.ApiError(405, "GET only")
                cid = clean[len("/api/campaigns/"):]
                return self._send_json(200,
                                       service.campaign_status(cid))
            if clean == "/api/metrics":
                # live health surface: the bound obs registry, fleet
                # dispatch gauges, admission state, and the compile
                # ledger -- Prometheus text exposition, authenticated
                # like every other route (the caller gate above)
                if method != "GET":
                    raise service.ApiError(405, "GET only")
                return self._send(
                    200, service.metrics_text(),
                    "text/plain; version=0.0.4; charset=utf-8")
            raise service.ApiError(404, f"unknown API route {path!r}")
        except service.ApiError as e:
            return self._send_json(e.status, e.payload,
                                   headers=e.headers)
        except BrokenPipeError:
            pass
        except Exception:  # noqa: BLE001
            logger.warning("api handler error", exc_info=True)
            try:
                self._send_json(500, {"error": "internal error"})
            except Exception:  # noqa: BLE001
                pass

    def do_POST(self):  # noqa: N802 - http.server API
        try:
            path = urllib.parse.unquote(
                urllib.parse.urlparse(self.path).path)
            if path.startswith("/api/"):
                return self._api("POST", path)
            return self._send(404, "<h1>404</h1>")
        except BrokenPipeError:
            pass
        except Exception:  # noqa: BLE001
            logger.warning("web handler error", exc_info=True)
            try:
                self._send(500, "<h1>500</h1>")
            except Exception:  # noqa: BLE001
                pass

    def do_GET(self):  # noqa: N802 - http.server API
        try:
            path = urllib.parse.unquote(
                urllib.parse.urlparse(self.path).path)
            if path.startswith("/api/"):
                return self._api("GET", path)
            if self._gate_html():
                return None
            if path in ("", "/"):
                return self._send(200, _home_page())
            if path.rstrip("/") == "/campaigns":
                return self._send(200, _campaigns_page())
            if path.startswith("/files/"):
                return self._files(path[len("/files/"):])
            return self._send(404, "<h1>404</h1>")
        except BrokenPipeError:
            pass
        except Exception:  # noqa: BLE001
            logger.warning("web handler error", exc_info=True)
            try:
                self._send(500, "<h1>500</h1>")
            except Exception:  # noqa: BLE001
                pass

    def _files(self, rel):
        want_zip = rel.endswith(".zip")
        if want_zip:
            rel = rel[:-len(".zip")]
        base = os.path.realpath(store.base_dir)
        full = os.path.realpath(os.path.join(base, rel.strip("/")))
        # path-traversal guard (web.clj:304-309)
        if not (full == base or full.startswith(base + os.sep)):
            return self._send(403, "<h1>403</h1>")
        if not os.path.exists(full):
            # download on demand: a remote cell whose artifact sync
            # failed terminally registered its run with fleet.sync --
            # pull it now so the run link resolves the moment the
            # worker host is reachable again (cheap no-op otherwise)
            from .fleet import sync as fsync
            if not (fsync.pending()
                    and fsync.fetch_on_demand(rel.strip("/"))
                    and os.path.exists(full)):
                return self._send(404, "<h1>404</h1>")
        if want_zip and os.path.isdir(full):
            return self._send(200, _zip_dir(full), "application/zip")
        if os.path.isdir(full):
            if rel and not rel.endswith("/"):
                # dir pages use relative links; force the trailing slash
                # so they resolve against this directory
                self.send_response(301)
                self.send_header("Location",
                                 f"/files/{urllib.parse.quote(rel)}/")
                self.end_headers()
                return None
            return self._send(200, _dir_page(rel.strip("/"), full))
        ctype = "text/plain; charset=utf-8"
        if full.endswith(".html"):
            ctype = "text/html; charset=utf-8"
        elif full.endswith(".png"):
            ctype = "image/png"
        elif full.endswith(".json") or full.endswith(".jsonl"):
            ctype = "application/json"
        with open(full, "rb") as f:
            return self._send(200, f.read(), ctype)


def serve(opts=None):
    """Starts the server; returns it (web.clj:361-366). Options: ip
    (default 0.0.0.0), port (default 8080), device (the service's
    device, None: CUDA), plus the admission knobs -- token (Bearer
    token requests must present), budgets (a service.DEFAULT_BUDGETS
    overlay), queue-wait-s -- which configure the service gate before
    the socket opens, and the cross-tenant coalescing knobs --
    coalesce? (default True: queued ``jax-wgl`` /api/check submissions
    merge into one padded device batch), coalesce-window-ms,
    coalesce-max-segments, capacity-plan (a capplan plan dict or a
    capacity_plan.json path whose predicted (model, bucket) shapes
    pre-register on the coalescer, so first-window strangers land in
    planned shapes instead of discovering them; a plan that cannot be
    read is logged and skipped, as in the reference)."""
    from .fleet import service
    opts = opts or {}
    qw = opts.get("queue-wait-s")
    if opts.get("token") or opts.get("budgets") or qw is not None:
        # NB ``qw or 15.0`` would coerce a legal explicit 0 (shed
        # immediately, never queue) back to the default
        service.configure(
            token=opts.get("token"), budgets=opts.get("budgets"),
            queue_wait_s=15.0 if qw is None else qw)
    planned = None
    cap = opts.get("capacity-plan")
    if cap is not None:
        try:
            from .analysis import capplan
            plan = capplan.load_plan(str(cap)) \
                if not isinstance(cap, dict) else cap
            planned = sorted(capplan.predicted_keys(plan))
        except Exception:  # noqa: BLE001 - pre-registration is advisory
            logger.warning("couldn't pre-register capacity-plan "
                           "buckets (contained)", exc_info=True)
    service.configure_coalesce(
        enabled=opts.get("coalesce?", True),
        window_ms=opts.get("coalesce-window-ms"),
        max_segments=opts.get("coalesce-max-segments"),
        planned=planned, device=opts.get("device"))
    addr = (opts.get("ip", "0.0.0.0"), opts.get("port", 8080))
    server = Server(addr, Handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True,
                              name="jepsen web")
    thread.start()
    logger.info("Web server on http://%s:%d/", *server.server_address[:2])
    return server
