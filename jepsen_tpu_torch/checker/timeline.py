"""Renders an HTML timeline of a history (reference
jepsen/src/jepsen/checker/timeline.clj)."""

from __future__ import annotations

import html as _html
import logging

from .. import history as h
from .core import Checker

logger = logging.getLogger(__name__)

#: Maximum number of operations to render — keeps the timeline usable on
#: massive histories (timeline.clj:12-14).
OP_LIMIT = 10_000

TIMESCALE = 1e6       # nanoseconds per pixel
COL_WIDTH = 100       # pixels
GUTTER_WIDTH = 106    # pixels
HEIGHT = 16           # pixels

STYLESHEET = """\
.ops        { position: absolute; }
.op         { position: absolute; padding: 2px; border-radius: 2px;
              box-shadow: 0 1px 3px rgba(0,0,0,0.12),
                          0 1px 2px rgba(0,0,0,0.24);
              transition: all 0.3s cubic-bezier(.25,.8,.25,1);
              overflow: hidden; }
.op.invoke  { background: #eeeeee; }
.op.ok      { background: #6DB6FE; }
.op.info    { background: #FFAA26; }
.op.fail    { background: #FEB5DA; }
.op:target  { box-shadow: 0 14px 28px rgba(0,0,0,0.25),
                          0 10px 10px rgba(0,0,0,0.22); }
"""


def _style(m):
    return ";".join(f"{k}:{v}" for k, v in m.items())


def _pairs(history):
    """[invoke, completion] / [lone-info] pairs in history order
    (timeline.clj:38-57)."""
    invocations = {}
    out = []
    for op in history:
        t = op.get("type")
        p = op.get("process")
        if t == "invoke":
            invocations[p] = op
        elif t == "info" and p not in invocations:
            out.append([op])
        elif t in ("ok", "fail", "info"):
            inv = invocations.pop(p, None)
            if inv is not None:
                out.append([inv, op])
            else:
                out.append([op])
    # ops still in flight at the end of the history render as lone
    # invocations (.op.invoke bars)
    for inv in invocations.values():
        out.append([inv])
    return out


def _is_nemesis(op):
    return op.get("process") == "nemesis"


def _title(test, op, start, stop):
    parts = []
    if _is_nemesis(op):
        parts.append(f"Msg: {start.get('value')!r}")
    if stop is not None:
        dur = int((stop.get("time", 0) - start.get("time", 0)) / 1e6)
        parts.append(f"Dur: {dur} ms")
    parts.append(f"Err: {op.get('error')!r}")
    parts.append("")
    extra = {k: v for k, v in op.items()
             if k not in ("process", "type", "f", "index", "sub_index",
                          "value", "time")}
    parts.append("Op:\n" + "\n ".join(
        [f"{{process {op.get('process')}",
         f"type {op.get('type')}",
         f"f {op.get('f')}"] +
        [f"{k} {v!r}" for k, v in extra.items()] +
        [f"value {op.get('value')!r}}}"]))
    return "\n".join(parts)


def _body(op, start, stop):
    same = stop is not None and start.get("value") == stop.get("value")
    s = f"{op.get('process')} {op.get('f')} "
    if not _is_nemesis(op):
        s += _html.escape(repr(start.get("value")))
    if stop is not None and not same:
        s += "<br />" + _html.escape(repr(stop.get("value")))
    return s


def _pair_div(n_hist, test, process_index, pair):
    start = pair[0]
    stop = pair[1] if len(pair) > 1 else None
    op = stop or start
    p = start.get("process")
    s = {"width": COL_WIDTH,
         "left": GUTTER_WIDTH * process_index.get(p, 0),
         "top": HEIGHT * start.get("sub_index", 0)}
    if stop is not None and stop.get("type") == "info":
        s["height"] = HEIGHT * (n_hist + 1 - start.get("sub_index", 0))
    elif stop is not None:
        s["height"] = HEIGHT * max(1, (stop.get("sub_index", 0)
                                       - start.get("sub_index", 0)))
    else:
        s["height"] = HEIGHT
    idx = op.get("index")
    title = _html.escape(_title(test, op, start, stop), quote=True)
    return (f'<a href="#i{idx}">'
            f'<div class="op {op.get("type")}" id="i{idx}" '
            f'style="{_style(s)}" title="{title}">'
            f'{_body(op, start, stop)}</div></a>')


def _process_index(history):
    """Maps processes to columns: clients sorted first, then named
    processes like the nemesis (timeline.clj:169-175)."""
    procs = []
    for op in history:
        p = op.get("process")
        if p not in procs:
            procs.append(p)
    ints = sorted(p for p in procs if isinstance(p, int))
    names = sorted((p for p in procs if not isinstance(p, int)), key=str)
    return {p: i for i, p in enumerate(ints + names)}


class _TimelineHtml(Checker):
    def check(self, test, hist, opts=None):
        opts = opts or {}
        hist = h.complete(h.ensure_indexed(hist))
        for i, op in enumerate(hist):
            op["sub_index"] = i
        pairs = _pairs(hist)
        pair_count = len(pairs)
        truncated = pair_count > OP_LIMIT
        pairs = pairs[:OP_LIMIT]
        pindex = _process_index(hist)
        key = opts.get("history-key")
        divs = "\n".join(_pair_div(len(hist), test, pindex, pr)
                         for pr in pairs)
        warning = (f'<div class="truncation-warning">Showing only '
                   f"{OP_LIMIT} of {pair_count} operations in this "
                   f"history.</div>" if truncated else "")
        doc = f"""<html><head><style>{STYLESHEET}</style></head>
<body><h1>{_html.escape(str(test.get('name')))} key {key}</h1>
{warning}
<div class="ops">
{divs}
</div></body></html>"""
        try:
            from .. import store
            p = store.make_path(test, opts.get("subdirectory"),
                                "timeline.html")
            with open(p, "w") as f:
                f.write(doc)
        except (AssertionError, OSError):
            logger.debug("timeline: no store directory; skipping write")
        return {"valid": True}


def html():
    return _TimelineHtml()
