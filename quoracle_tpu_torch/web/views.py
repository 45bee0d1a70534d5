"""Standalone server-rendered dashboard views: /logs, /mailbox, /telemetry.

The reference ships dedicated cross-task pages alongside the main SPA —
LogViewLive + MailboxLive (reference lib/quoracle_web/router.ex:22-32) and
the dev LiveDashboard telemetry page (router.ex:42-50). This image has no
JS engine or browser, so these views are rendered SERVER-SIDE to complete
HTML documents: the DOM a test can parse and assert on directly
(tests/test_dashboard_dom.py), and a no-JS fallback surface for operators.

Each page is a pure function of read-model payloads → HTML string; the
HTTP handler (web/server.py) routes GET /logs, /mailbox, /telemetry here.

The PyTorch port's copy of ``quoracle_tpu/web/views.py``. Its telemetry
page also lists the planes the port has not got (``not_ported``), whose
panels the JAX page renders from payloads the port cannot build.
"""

from __future__ import annotations

import html
import time
from typing import Any, Optional

_STYLE = """
  :root { color-scheme: dark; }
  body { margin: 0; font: 13px/1.5 ui-monospace, Menlo, monospace;
         background: #14161a; color: #d6d8dd; }
  header { display: flex; gap: 16px; align-items: baseline;
           padding: 10px 16px; border-bottom: 1px solid #2a2d33; }
  header h1 { font-size: 14px; margin: 0; color: #fff; }
  header a { color: #9ecbff; text-decoration: none; }
  main { padding: 12px 16px; }
  table { border-collapse: collapse; width: 100%; margin-bottom: 16px; }
  th, td { text-align: left; padding: 4px 10px 4px 0; vertical-align: top;
           border-bottom: 1px solid #1c1f24; }
  th { color: #8b8f98; font-weight: 600; text-transform: uppercase;
       font-size: 11px; letter-spacing: .06em; }
  .lvl-error { color: #ff9a9a; }
  .lvl-warning { color: #ffd28a; }
  .lvl-decision { color: #9ecbff; }
  .meta { color: #8b8f98; }
  .aid { color: #b7e3a8; }
  .from { color: #d9b8ff; }
  .todo-done { text-decoration: line-through; color: #8b8f98; }
  form.filter { display: flex; gap: 8px; margin-bottom: 12px; }
  select, input, button { font: inherit; background: #1a1d22;
    color: #d6d8dd; border: 1px solid #2a2d33; border-radius: 6px;
    padding: 4px 8px; }
  .card { background: #1a1d22; border-radius: 8px; padding: 8px 12px;
          margin-bottom: 8px; }
"""


def _e(x: Any) -> str:
    return html.escape(str(x if x is not None else ""))


def _ts(ts: Optional[float]) -> str:
    if not ts:
        return ""
    return time.strftime("%H:%M:%S", time.localtime(ts))


def _kv_rows(d: dict) -> str:
    """Sorted key/value 2-column rows — the one dict-table renderer
    (/settings and /telemetry both build on it)."""
    return "".join(
        f"<tr><td class=\"meta\">{_e(k)}</td><td>{_e(v)}</td></tr>"
        for k, v in sorted(d.items()))


def _page(title: str, body: str, refresh: int = 5) -> str:
    return (f"<!doctype html><html lang=\"en\"><head>"
            f"<meta charset=\"utf-8\"><title>{_e(title)}</title>"
            f"<meta http-equiv=\"refresh\" content=\"{refresh}\">"
            f"<style>{_STYLE}</style></head><body>"
            f"<header><h1>quoracle-tpu</h1>"
            f"<a href=\"/\">dashboard</a><a href=\"/logs\">logs</a>"
            f"<a href=\"/mailbox\">mailbox</a>"
            f"<a href=\"/telemetry\">telemetry</a>"
            f"<a href=\"/settings\">settings</a>"
            f"<span class=\"meta\">{_e(title)}</span></header>"
            f"<main>{body}</main></body></html>")


def _task_strip(tasks: list[dict], selected: Optional[str],
                base_path: str) -> str:
    """Cross-task header table: id, status, live agents, cost roll-up,
    with filter links. Shared by /logs and /mailbox."""
    rows = "".join(
        f"<tr class=\"task-row\" data-task=\"{_e(t['id'])}\">"
        f"<td><a href=\"{base_path}?task_id={_e(t['id'])}\">{_e(t['id'])}"
        f"</a></td><td>{_e(t.get('status'))}</td>"
        f"<td>{_e(t.get('live_agents', 0))}</td>"
        f"<td class=\"task-cost\">{_e(t.get('cost'))}</td></tr>"
        for t in tasks)
    sel = (f"<p class=\"meta\">filtered to task "
           f"<b>{_e(selected)}</b> — <a href=\"{base_path}\">all tasks"
           f"</a></p>" if selected else "")
    return (f"<table id=\"tasks\"><tr><th>task</th><th>status</th>"
            f"<th>agents</th><th>cost</th></tr>{rows}</table>{sel}")


def logs_page(tasks: list[dict], logs: list[dict],
              task_id: Optional[str], level: Optional[str]) -> str:
    """Cross-task log view (reference LogViewLive): every agent's durable
    logs, joined to their task, filterable by task and level."""
    rows = "".join(
        f"<tr class=\"log-row lvl-{_e(r.get('level'))}\">"
        f"<td class=\"meta\">{_ts(r.get('ts'))}</td>"
        f"<td>{_e(r.get('task_id'))}</td>"
        f"<td class=\"aid\">{_e(r.get('agent_id'))}</td>"
        f"<td class=\"lvl-{_e(r.get('level'))}\">{_e(r.get('level'))}</td>"
        f"<td>{_e(r.get('message'))}</td></tr>"
        for r in logs)
    body = (_task_strip(tasks, task_id, "/logs")
            + f"<table id=\"logs\"><tr><th>time</th><th>task</th>"
              f"<th>agent</th><th>level</th><th>message</th></tr>"
              f"{rows}</table>"
            + (f"<p class=\"meta\">level filter: {_e(level)}</p>"
               if level else ""))
    return _page("logs", body)


def mailbox_page(tasks: list[dict], agents: list[dict],
                 messages: list[dict], task_id: Optional[str]) -> str:
    """Cross-task mailbox (reference MailboxLive) extended with the agent
    panel: per-agent cards carry live todos and the cost roll-up the SPA's
    badges show — the server-rendered DOM a test asserts against."""
    cards = []
    for a in agents:
        todos = "".join(
            f"<li class=\"todo{' todo-done' if t.get('done') else ''}\">"
            f"{_e(t.get('task'))}</li>"
            for t in (a.get("todos") or []))
        budget = a.get("budget") or {}
        cards.append(
            f"<div class=\"card agent-card\" "
            f"data-agent=\"{_e(a['agent_id'])}\">"
            f"<span class=\"aid\">{_e(a['agent_id'])}</span> "
            f"<span class=\"meta\">profile={_e(a.get('profile'))} "
            f"node={_e(a.get('grove_node'))} "
            f"pending={_e(a.get('pending_actions'))}</span> "
            f"<span class=\"agent-cost\">cost={_e(a.get('cost'))}</span>"
            + (f" <span class=\"meta\">budget avail="
               f"{_e(budget.get('available'))}</span>" if budget else "")
            + (f"<ul class=\"todos\">{todos}</ul>" if todos else "")
            + "</div>")
    msgs = "".join(
        f"<div class=\"card msg\"><span class=\"from\">"
        f"{_e(r.get('sender'))}</span> "
        f"<span class=\"meta\">{_ts(r.get('ts'))} "
        f"{_e(r.get('message_type'))} → {_e(r.get('targets'))}</span>"
        f"<div>{_e(r.get('content'))}</div></div>"
        for r in messages)
    body = (_task_strip(tasks, task_id, "/mailbox")
            + f"<h2 class=\"meta\">agents</h2><div id=\"agents\">"
              f"{''.join(cards)}</div>"
            + f"<h2 class=\"meta\">messages</h2><div id=\"messages\">"
              f"{msgs}</div>")
    return _page("mailbox", body)


def settings_page(payload: dict, credentials: list[dict]) -> str:
    """Read-only standalone settings view (reference /settings route,
    SecretManagementLive): system settings, profiles, secret NAMES,
    credential metadata, served model catalog. Mutations stay on the
    SPA/API — this page is the at-a-glance audit surface."""
    def kv_table(tid: str, d: dict) -> str:
        rows = _kv_rows(d)
        return (f"<table id=\"{_e(tid)}\">{rows}</table>"
                if rows else "<p class=\"meta\">none</p>")

    profiles = "".join(
        f"<div class=\"card profile\" data-profile=\"{_e(n)}\">"
        f"<b>{_e(n)}</b> <span class=\"meta\">{_e(p)}</span></div>"
        for n, p in sorted((payload.get("profiles") or {}).items()))
    secrets = "".join(
        f"<li class=\"secret\">{_e(s.get('name'))} "
        f"<span class=\"meta\">{_e(s.get('description'))}</span></li>"
        for s in sorted(payload.get("secrets") or [],
                        key=lambda s: s.get("name", "")))
    creds = "".join(
        f"<tr class=\"credential\"><td>{_e(c.get('id'))}</td>"
        f"<td>{_e(c.get('model_spec'))}</td>"
        f"<td>{_e(bool(c.get('encrypted')))}</td></tr>"
        for c in credentials)
    body = (
        "<h2 class=\"meta\">system settings</h2>"
        + kv_table("settings", payload.get("settings") or {})
        + "<h2 class=\"meta\">profiles</h2>"
        + (profiles or "<p class=\"meta\">none</p>")
        + "<h2 class=\"meta\">secrets (names only — values never leave "
          "the vault)</h2>"
        + (f"<ul id=\"secrets\">{secrets}</ul>" if secrets
           else "<p class=\"meta\">none</p>")
        + "<h2 class=\"meta\">credentials (metadata only)</h2>"
        + (f"<table id=\"credentials\"><tr><th>id</th><th>model_spec</th>"
           f"<th>encrypted</th></tr>{creds}</table>" if creds
           else "<p class=\"meta\">none</p>")
        + "<h2 class=\"meta\">served models</h2>"
        + "<ul id=\"models\">"
        + "".join(f"<li>{_e(m)}</li>"
                  for m in payload.get("models") or []) + "</ul>"
        + f"<p class=\"meta\">default pool: "
          f"{_e(payload.get('default_pool'))}</p>")
    return _page("settings", body, refresh=15)


def _fmt_ms(v: Any) -> str:
    return f"{v:.2f}" if isinstance(v, (int, float)) else ""


def latency_panel(telemetry: dict) -> str:
    """Histogram-quantile latency table (the panel wires into the
    dashboard views): one row per histogram instrument — and per label
    series under it — with count and p50/p95/p99, from the
    infra/telemetry.py snapshot embedded in /api/metrics."""
    rows = []
    for name, m in sorted(telemetry.items()):
        if m.get("type") != "histogram":
            continue
        rows.append(
            f"<tr class=\"hist\" data-metric=\"{_e(name)}\">"
            f"<td>{_e(name)}</td><td>{_e(m.get('count', 0))}</td>"
            f"<td>{_fmt_ms(m.get('p50'))}</td>"
            f"<td>{_fmt_ms(m.get('p95'))}</td>"
            f"<td>{_fmt_ms(m.get('p99'))}</td></tr>")
        for label, s in sorted((m.get("series") or {}).items()):
            if not label:
                continue
            rows.append(
                f"<tr class=\"hist-series\">"
                f"<td class=\"meta\">&nbsp;&nbsp;{_e(label)}</td>"
                f"<td>{_e(s.get('count', 0))}</td>"
                f"<td>{_fmt_ms(s.get('p50'))}</td>"
                f"<td>{_fmt_ms(s.get('p95'))}</td>"
                f"<td>{_fmt_ms(s.get('p99'))}</td></tr>")
    if not rows:
        return ""
    return ("<h2 class=\"meta\">latency (histogram quantiles)</h2>"
            "<table id=\"latency\"><tr><th>metric</th><th>count</th>"
            "<th>p50</th><th>p95</th><th>p99</th></tr>"
            + "".join(rows) + "</table>")


def _mb(v: Any) -> str:
    return (f"{v / (1024 * 1024):.1f}"
            if isinstance(v, (int, float)) else "")


def resources_panel(res: dict) -> str:
    """Live resource panel: device memory, per-engine HBM
    attribution, compile-cache health, scheduler queue health, and the
    flight recorder's status — the /api/resources payload as tables."""
    if not res:
        return ""
    parts = ["<h2 class=\"meta\">resources</h2>"]
    devs = res.get("devices") or []
    if devs:
        rows = "".join(
            f"<tr class=\"device-row\"><td>{_e(d.get('device'))}</td>"
            f"<td>{_e(d.get('kind'))}</td>"
            f"<td>{_mb(d.get('bytes_in_use'))}</td>"
            f"<td>{_mb(d.get('bytes_limit')) or '—'}</td>"
            f"<td class=\"meta\">{_e(d.get('source'))}</td></tr>"
            for d in devs)
        parts.append(
            "<table id=\"devices\"><tr><th>device</th><th>kind</th>"
            "<th>used MB</th><th>limit MB</th><th>source</th></tr>"
            + rows + "</table>")
    members = (res.get("hbm") or {}).get("members") or {}
    if members:
        rows = "".join(
            f"<tr class=\"hbm-row\" data-model=\"{_e(spec)}\">"
            f"<td>{_e(spec)}</td><td>{_mb(m.get('params_bytes'))}</td>"
            f"<td>{_mb(m.get('kv_pool_bytes'))}</td>"
            f"<td>{_e(m.get('kv_free_pages'))}</td>"
            f"<td>{_e(m.get('prefix_cache_pages'))}</td>"
            f"<td>{_e(m.get('sessions'))}</td></tr>"
            for spec, m in sorted(members.items()))
        parts.append(
            "<table id=\"hbm\"><tr><th>model</th><th>params MB</th>"
            "<th>kv pool MB</th><th>free pages</th><th>cache pages</th>"
            "<th>sessions</th></tr>" + rows + "</table>")
    comp = res.get("compile") or {}
    if comp:
        rows = "".join(
            f"<tr class=\"compile-row\" data-model=\"{_e(spec)}\">"
            f"<td>{_e(spec)}</td><td>{_e(c.get('hits'))}</td>"
            f"<td>{_e(c.get('misses'))}</td>"
            f"<td>{_e(c.get('hit_rate'))}</td>"
            f"<td>{'STORM' if c.get('storm') else ''}</td></tr>"
            for spec, c in sorted(comp.items()))
        parts.append(
            "<table id=\"compiles\"><tr><th>model</th><th>hits</th>"
            "<th>misses</th><th>hit rate</th><th></th></tr>"
            + rows + "</table>")
    sched = res.get("scheduler") or {}
    if sched:
        def _pad(s):
            # padding-waste roll-up: real / padded chunk tokens
            # and the waste fraction raggedness reclaims
            p = s.get("padding") or {}
            if not p.get("padded_tokens"):
                return "—"
            ratio = p.get("waste_ratio")
            pct = f" ({ratio * 100:.1f}% pad)" if ratio is not None else ""
            return (f"{_e(p.get('real_tokens'))}/"
                    f"{_e(p.get('padded_tokens'))}{pct}")

        rows = "".join(
            f"<tr class=\"sched-row\" data-model=\"{_e(spec)}\">"
            f"<td>{_e(spec)}</td><td>{_e(s.get('queued'))}</td>"
            f"<td>{_e(s.get('live'))}/{_e(s.get('max_slots'))}</td>"
            f"<td>{_e(s.get('retired'))}</td>"
            f"<td>{_e(s.get('failed'))}</td>"
            f"<td class=\"pad-cell\">{_pad(s)}</td></tr>"
            for spec, s in sorted(sched.items()))
        parts.append(
            "<table id=\"scheduler\"><tr><th>model</th><th>queued</th>"
            "<th>slots</th><th>retired</th><th>failed</th>"
            "<th>real/padded tok</th></tr>"
            + rows + "</table>")
    fr = res.get("flight_recorder") or {}
    if fr:
        parts.append(
            f"<p class=\"meta\" id=\"flightrec\">flight recorder: "
            f"{_e(fr.get('n_events'))}/{_e(fr.get('capacity'))} events, "
            f"{_e(fr.get('dumps'))} dumps, last="
            f"{_e(fr.get('last_dump') or 'none')}</p>")
    wd = res.get("watchdog") or {}
    if wd.get("tripped"):
        parts.append(f"<p class=\"lvl-error\" id=\"watchdog\">STALLED: "
                     f"{_e(', '.join(wd['tripped']))}</p>")
    return "".join(parts)


def qos_panel(qos: dict) -> str:
    """Serving-QoS panel: admission signals + shed counts,
    per-class weighted-fair queue state, and the SLO tracker's tails —
    the /api/qos payload as tables. Renders nothing while QoS is off."""
    if not qos or not qos.get("enabled"):
        return ""
    parts = ["<h2 class=\"meta\">serving QoS</h2>"]
    adm = qos.get("admission") or {}
    parts.append(
        f"<p class=\"meta\" id=\"qos-admission\">admitted "
        f"{_e(adm.get('admitted'))} · shed {_e(adm.get('shed'))} · "
        f"queue depth {_e(adm.get('queue_depth'))} · admit-wait p95 "
        f"{_fmt_ms(adm.get('admit_wait_p95_ms'))}ms · HBM headroom "
        f"{_e(adm.get('hbm_headroom'))}</p>")
    slo = qos.get("slo") or {}
    rows = "".join(
        f"<tr class=\"slo-row\" data-cls=\"{_e(cls)}\">"
        f"<td>{_e(cls)}</td><td>{_fmt_ms(c.get('tail_ms'))}</td>"
        f"<td>{_fmt_ms(c.get('target_ms'))}</td>"
        f"<td>{_e(c.get('observed'))}</td></tr>"
        for cls, c in sorted((slo.get("classes") or {}).items()))
    if rows:
        demoted = (" — BULK DEMOTED" if slo.get("demoted") else "")
        parts.append(
            f"<table id=\"qos-slo\"><tr><th>class{_e(demoted)}</th>"
            "<th>tail ms</th><th>target ms</th><th>observed</th></tr>"
            + rows + "</table>")
    for spec, q in sorted((qos.get("queues") or {}).items()):
        if not q or q.get("policy") != "weighted_fair":
            continue
        rows = "".join(
            f"<tr class=\"qos-queue-row\"><td>{_e(cls)}</td>"
            f"<td>{_e(c.get('queued'))}</td><td>{_e(c.get('weight'))}</td>"
            f"<td>{_e(c.get('served'))}</td>"
            f"<td>{_e(c.get('oldest_wait_s') or '')}</td></tr>"
            for cls, c in sorted((q.get("classes") or {}).items()))
        parts.append(
            f"<table class=\"qos-queue\" data-model=\"{_e(spec)}\">"
            f"<tr><th>{_e(spec)}</th><th>queued</th><th>weight</th>"
            f"<th>served</th><th>oldest wait s</th></tr>"
            + rows + "</table>")
    tenants = adm.get("tenants") or {}
    if tenants:
        rows = "".join(
            f"<tr class=\"tenant-row\"><td>{_e(name)}</td>"
            f"<td>{_e(t.get('rate_per_s') or '∞')}</td>"
            f"<td>{_e(t.get('tokens'))}</td>"
            f"<td>{_e(t.get('max_class'))}</td></tr>"
            for name, t in sorted(tenants.items()))
        parts.append(
            "<table id=\"qos-tenants\"><tr><th>tenant</th>"
            "<th>rate/s</th><th>tokens</th><th>max class</th></tr>"
            + rows + "</table>")
    return "".join(parts)


def _rate(v: Any) -> str:
    return f"{v:.1%}" if isinstance(v, (int, float)) else "—"


def quality_panel(quality: dict) -> str:
    """Consensus-quality panel: per-member scorecards —
    agreement/dissent rates, failures by kind, correction recovery,
    proposal latency, and the drift flag — the /api/models payload as a
    table. Renders nothing before the first decide."""
    members = (quality or {}).get("members") or {}
    if not members:
        return ""
    parts = ["<h2 class=\"meta\">consensus quality (per-model scorecards)"
             "</h2>"]
    rows = []
    for spec, s in sorted(members.items()):
        fails = ", ".join(f"{k}:{n}"
                          for k, n in sorted((s.get("failures") or {})
                                             .items())) or "—"
        drifting = ", ".join(s.get("drifting") or ())
        rows.append(
            f"<tr class=\"quality-row\" data-model=\"{_e(spec)}\">"
            f"<td>{_e(spec)}</td><td>{_e(s.get('decides'))}</td>"
            f"<td>{_rate(s.get('agreement_rate'))}</td>"
            f"<td>{_rate(s.get('dissent_rate'))}</td>"
            f"<td>{_e(fails)}</td>"
            f"<td>{_rate(s.get('recovery_rate'))}</td>"
            f"<td>{_fmt_ms(s.get('latency_p50_ms'))}</td>"
            f"<td>{_fmt_ms(s.get('chip_ms_per_decide'))}</td>"
            + (f"<td class=\"lvl-error\">DRIFT: {_e(drifting)}</td>"
               if drifting else "<td></td>")
            + "</tr>")
    parts.append(
        "<table id=\"quality\"><tr><th>model</th><th>decides</th>"
        "<th>agree</th><th>dissent</th><th>failures</th><th>recovery</th>"
        "<th>latency p50</th><th>chip/decide</th><th></th></tr>"
        + "".join(rows) + "</table>")
    drifting = (quality or {}).get("drifting") or []
    if drifting:
        parts.append(f"<p class=\"lvl-error\" id=\"quality-drift\">"
                     f"MODEL HEALTH DRIFT: {_e(', '.join(drifting))}</p>")
    return "".join(parts)


def spec_panel(spec: dict) -> str:
    """Speculative-serving panel: per-member draft pairing,
    rolling acceptance / tokens-per-round, the adaptive-K state, and
    fallback attribution — the /api/models ``speculative`` block as a
    table. Renders nothing while no member has a draft."""
    members = (spec or {}).get("members") or {}
    if not (spec or {}).get("enabled") or not members:
        return ""
    parts = ["<h2 class=\"meta\">speculative serving</h2>"]
    rows = []
    for model, s in sorted(members.items()):
        falls = ", ".join(f"{k}:{n}"
                          for k, n in sorted((s.get("fallbacks") or {})
                                             .items())) or "—"
        state = ("engaged" if s.get("engaged")
                 else "batch1" if s.get("mode") == "batch1" else "OFF")
        rows.append(
            f"<tr class=\"spec-row\" data-model=\"{_e(model)}\">"
            f"<td>{_e(model)}</td><td>{_e(s.get('draft'))}</td>"
            f"<td>{_e(state)}</td><td>{_e(s.get('k'))}</td>"
            f"<td>{_rate(s.get('acceptance_rate'))}</td>"
            f"<td>{_e(s.get('tokens_per_round') or '—')}</td>"
            f"<td>{_e(s.get('rounds') or 0)}</td>"
            f"<td>{_e(falls)}</td></tr>")
    parts.append(
        "<table id=\"speculative\"><tr><th>model</th><th>draft</th>"
        "<th>state</th><th>K</th><th>accept</th><th>tok/round</th>"
        "<th>rounds</th><th>fallbacks</th></tr>" + "".join(rows)
        + "</table>")
    return "".join(parts)


def kv_panel(kv: dict) -> str:
    """Tiered-KV panel: per-member tier ladder occupancy —
    HBM pages, host-tier bytes/entries, disk-store entries — and the
    demote/restore flow counters, the /api/kv payload as a table.
    Renders nothing while tiering is off."""
    members = (kv or {}).get("members") or {}
    if not (kv or {}).get("enabled") or not members:
        return ""
    parts = ["<h2 class=\"meta\">tiered KV</h2>"]
    rows = []
    for model, m in sorted(members.items()):
        hbm = m.get("hbm") or {}
        host = m.get("host") or {}
        disk = m.get("disk") or {}
        quant = m.get("quant") or {}
        # compression column: int8 members show their
        # bf16-vs-actual byte ratio; unquantized members show 1.0x
        comp = quant.get("kv_compression")
        comp_s = (f"{comp}x int8" if quant.get("quantize_kv")
                  else "1.0x bf16")
        rows.append(
            f"<tr class=\"kv-row\" data-model=\"{_e(model)}\">"
            f"<td>{_e(model)}</td>"
            f"<td>{_e(hbm.get('used_pages'))}/"
            f"{_e(hbm.get('pages'))}</td>"
            f"<td>{_e(hbm.get('sessions'))}</td>"
            f"<td>{_mb(host.get('bytes'))}/"
            f"{_mb(host.get('budget_bytes'))}</td>"
            f"<td>{_e(host.get('sessions'))}+"
            f"{_e(host.get('prefix_blocks'))}</td>"
            f"<td>{_e(disk.get('entries') if disk else '—')}</td>"
            f"<td>{_e(m.get('demoted_sessions'))}/"
            f"{_e(m.get('restored_sessions'))}</td>"
            f"<td>{_e(disk.get('corrupt_skipped') if disk else '—')}"
            f"</td>"
            f"<td class=\"kv-comp\">{_e(comp_s)}</td></tr>")
    parts.append(
        "<table id=\"kvtier\"><tr><th>model</th><th>hbm pages</th>"
        "<th>sessions</th><th>host MB</th><th>host sess+pfx</th>"
        "<th>disk entries</th><th>demote/restore</th>"
        "<th>corrupt</th><th>compression</th></tr>"
        + "".join(rows) + "</table>")
    return "".join(parts)


def chaos_panel(chaos: dict) -> str:
    """Chaos-plane panel: armed-plan state, fired-fault
    counts per injection point, and the last scenario's invariant
    verdicts — the /api/chaos payload as tables. Renders nothing while
    the plane has never been armed and no scenario has run."""
    chaos = chaos or {}
    armed = chaos.get("armed")
    last = chaos.get("last_scenario")
    fired = chaos.get("fired") or []
    if not armed and not last and not fired:
        return ""
    parts = [f"<h2 class=\"meta\">chaos plane "
             f"({'ARMED' if armed else 'disarmed'})</h2>"]
    plan = chaos.get("plan") or {}
    if plan:
        parts.append(
            f"<p class=\"meta\" id=\"chaos-plan\">seed {_e(plan.get('seed'))}"
            f" · {_e(len(plan.get('rules') or []))} rule(s)"
            f" · {_e(plan.get('fired'))} fault(s) fired</p>")
    if last:
        rows = "".join(
            f"<tr class=\"chaos-inv\" data-ok=\"{int(bool(r.get('ok')))}\">"
            f"<td>{_e(r.get('name'))}</td>"
            f"<td>{'pass' if r.get('ok') else 'FAIL'}</td>"
            f"<td>{_e((r.get('detail') or '')[:120])}</td></tr>"
            for r in last.get("invariants") or [])
        parts.append(
            f"<h3 class=\"meta\">last scenario: {_e(last.get('name'))} "
            f"(seed {_e(last.get('seed'))}, "
            f"{'PASS' if last.get('passed') else 'FAIL'}, "
            f"{_e(last.get('faults_fired'))} faults)</h3>"
            "<table id=\"chaos-invariants\"><tr><th>invariant</th>"
            "<th>verdict</th><th>detail</th></tr>" + rows + "</table>")
    return "".join(parts)


def fleet_panel(fleet: dict) -> str:
    """Elastic-fleet panel: policy config + tick state, the
    recent action ledger, and the drain/migration totals — the
    /api/fleet payload as tables. Renders nothing on runtimes without
    a FleetController."""
    fleet = fleet or {}
    if not fleet.get("enabled"):
        return ""
    cfg = fleet.get("config") or {}
    parts = [
        "<h2 class=\"meta\">elastic fleet</h2>",
        f"<p class=\"meta\" id=\"fleet-state\">"
        f"ticks {_e(fleet.get('ticks'))}"
        f" · cooldown {_e(fleet.get('cooldown'))}"
        f" · drains {_e(fleet.get('drains'))}"
        f" · migrated {_e(fleet.get('sessions_migrated'))}"
        f" (failed {_e(fleet.get('sessions_failed'))})"
        f" · bounds [{_e(cfg.get('min_replicas'))}, "
        f"{_e(cfg.get('max_replicas'))}]"
        f" · seed {_e(cfg.get('seed'))}</p>",
    ]
    ledger = fleet.get("ledger") or []
    if ledger:
        rows = "".join(
            f"<tr class=\"fleet-action\"><td>{_e(a.get('tick'))}</td>"
            f"<td>{_e(a.get('action'))}</td>"
            f"<td>{_e(a.get('target'))}</td>"
            f"<td>{_e(a.get('role'))}</td>"
            f"<td>{_e((a.get('reason') or '')[:100])}</td></tr>"
            for a in ledger[-16:])
        parts.append(
            "<table id=\"fleet-ledger\"><tr><th>tick</th>"
            "<th>action</th><th>target</th><th>role</th>"
            "<th>reason</th></tr>" + rows + "</table>")
    return "".join(parts)


def sim_panel(sim: dict) -> str:
    """Fleet-simulator panel: the /api/sim payload as
    tables — loaded trace stats, the last replay's outcome counts and
    tier census, and the last gate report's invariant verdicts.
    Renders nothing until a trace is loaded or replayed."""
    sim = sim or {}
    if not sim.get("enabled"):
        return ""
    parts = ["<h2 class=\"meta\">fleet simulator</h2>"]
    trace = sim.get("trace") or {}
    if trace:
        parts.append(
            f"<p class=\"meta\" id=\"sim-trace\">trace "
            f"{_e(trace.get('digest'))} · events {_e(trace.get('events'))}"
            f" · sessions {_e(trace.get('sessions'))}"
            f" · horizon {_e(trace.get('horizon_ms'))}ms"
            f" · seed {_e(trace.get('seed'))}</p>")
    replay = sim.get("last_replay") or {}
    if replay:
        outcomes = replay.get("outcomes") or {}
        census = replay.get("census") or {}
        parts.append(
            f"<p class=\"meta\" id=\"sim-replay\">replay "
            f"{_e(replay.get('mode'))} · ledger {_e(replay.get('ledger'))}"
            f" · ok {_e(outcomes.get('ok'))}"
            f" · shed {_e(outcomes.get('shed'))}"
            f" · deadline {_e(outcomes.get('deadline'))}"
            f" · goodput {_e(replay.get('goodput_tok_s_virtual'))} tok/s"
            f" · compression ×{_e(replay.get('compression_x'))}</p>")
        if census:
            rows = "".join(
                f"<tr class=\"sim-tier\"><td>{_e(t)}</td>"
                f"<td>{_e(census.get(t))}</td></tr>"
                for t in ("resident", "host", "disk", "prefixd",
                          "dropped", "seen") if t in census)
            parts.append("<table id=\"sim-census\"><tr><th>tier</th>"
                         "<th>sessions</th></tr>" + rows + "</table>")
    report = sim.get("last_report") or {}
    if report:
        rows = "".join(
            f"<tr class=\"sim-invariant\"><td>{_e(r.get('name'))}</td>"
            f"<td>{'ok' if r.get('ok') else 'FAIL'}</td>"
            f"<td>{_e((r.get('detail') or '')[:100])}</td></tr>"
            for r in report.get("invariants") or [])
        parts.append(
            f"<p class=\"meta\" id=\"sim-gate\">gate "
            f"{_e(report.get('name'))} · seed {_e(report.get('seed'))}"
            f" · {'PASSED' if report.get('passed') else 'FAILED'}</p>"
            "<table id=\"sim-invariants\"><tr><th>invariant</th>"
            "<th>ok</th><th>detail</th></tr>" + rows + "</table>")
    return "".join(parts)


def timeline_panel(timeline: dict) -> str:
    """Session-timeline panel: the most recent traced
    session's cross-process lifecycle — per-stage TTFT attribution (the
    stages sum to the observed end-to-end wall by construction) plus
    the ordered span list, each span named with its replica. Renders
    nothing while no traced session is in the ring."""
    timeline = timeline or {}
    spans = timeline.get("spans") or []
    if not spans:
        return ""
    stages = timeline.get("stages") or {}
    parts = [
        "<h2 class=\"meta\">session timeline</h2>",
        f"<p class=\"meta\" id=\"timeline-state\">"
        f"session {_e(timeline.get('session_id'))}"
        f" · trace {_e(','.join(timeline.get('trace_ids') or []))}"
        f" · spans {_e(timeline.get('n_spans'))}"
        f" · total {_fmt_ms(timeline.get('total_ms'))}"
        f" (stages sum {_fmt_ms(timeline.get('stages_sum_ms'))})</p>",
    ]
    if stages:
        rows = "".join(
            f"<tr class=\"timeline-stage\"><td>{_e(k)}</td>"
            f"<td>{_fmt_ms(v)}</td></tr>"
            for k, v in stages.items())
        parts.append("<table id=\"timeline-stages\"><tr><th>stage</th>"
                     "<th>ms</th></tr>" + rows + "</table>")
    waits = timeline.get("waits") or {}
    if waits.get("by_state_ms"):
        rows = "".join(
            f"<tr class=\"timeline-wait\"><td>{_e(k)}</td>"
            f"<td>{_fmt_ms(v)}</td></tr>"
            for k, v in waits["by_state_ms"].items())
        parts.append(
            f"<p class=\"meta\">wait states · rows {_e(waits.get('rows'))}"
            f" · wall {_fmt_ms(waits.get('wall_ms'))}"
            f" · exact {_e(waits.get('exact'))}</p>"
            "<table id=\"timeline-waits\"><tr><th>wait state</th>"
            "<th>ms</th></tr>" + rows + "</table>")
    rows = "".join(
        f"<tr class=\"timeline-span\"><td>{_e(s.get('name'))}</td>"
        f"<td>{_e(s.get('replica') or s.get('model') or '')}</td>"
        f"<td>{_ts(s.get('ts'))}</td>"
        f"<td>{_fmt_ms(s.get('duration_ms'))}</td></tr>"
        for s in spans[:24])
    parts.append("<table id=\"timeline-spans\"><tr><th>span</th>"
                 "<th>where</th><th>start</th><th>ms</th></tr>"
                 + rows + "</table>")
    return "".join(parts)


def introspect_panel(profile: dict) -> str:
    """Liveness & hotspot panel: stall-detector status,
    the hottest collapsed stacks of the last closed profiler window,
    heartbeat counters, and per-state wait totals. Renders nothing
    while the plane is disabled (QUORACLE_INTROSPECT=0)."""
    profile = profile or {}
    if not profile.get("enabled"):
        return ""
    prof = profile.get("profiler") or {}
    stalls = profile.get("stalls") or {}
    parts = [
        "<h2 class=\"meta\">liveness &amp; hotspots</h2>",
        f"<p class=\"meta\" id=\"introspect-state\">"
        f"sample rate {_e(prof.get('hz'))} Hz"
        f" · samples {_e(prof.get('samples'))}"
        f" · overhead {_e(prof.get('overhead_frac'))}"
        f" · stalls {_e(stalls.get('trips'))}"
        f" ({_e(','.join(stalls.get('tripped') or []) or 'none live')}"
        f")</p>",
    ]
    windows = prof.get("windows") or []
    if windows:
        rows = "".join(
            f"<tr class=\"introspect-stack\"><td>{_e(stack)}</td>"
            f"<td>{_e(n)}</td></tr>"
            for stack, n in list(
                (windows[-1].get("stacks") or {}).items())[:12])
        parts.append("<table id=\"introspect-stacks\"><tr>"
                     "<th>collapsed stack</th><th>samples</th></tr>"
                     + rows + "</table>")
    beats = profile.get("heartbeats") or {}
    if beats:
        rows = "".join(
            f"<tr class=\"introspect-beat\"><td>{_e(k)}</td>"
            f"<td>{_e(v)}</td></tr>"
            for k, v in sorted(beats.items()))
        parts.append("<table id=\"introspect-beats\"><tr>"
                     "<th>heartbeat</th><th>count</th></tr>"
                     + rows + "</table>")
    return "".join(parts)


def telemetry_page(metrics: dict, resources: Optional[dict] = None,
                   qos: Optional[dict] = None,
                   quality: Optional[dict] = None,
                   kv: Optional[dict] = None,
                   chaos: Optional[dict] = None,
                   fleet: Optional[dict] = None,
                   timeline: Optional[dict] = None,
                   sim: Optional[dict] = None,
                   profile: Optional[dict] = None,
                   not_ported: Optional[dict] = None) -> str:
    """Dev telemetry view (reference LiveDashboard at /dev/dashboard):
    the /api/metrics snapshot as readable tables, led by the latency
    histogram panel, the live resources panel, the QoS panel, the
    tiered-KV panel, and the consensus-quality scorecards.
    ``not_ported`` ({plane: ROADMAP item}) lists the planes this
    package has no payload for."""
    def table(title: str, d: dict) -> str:
        return (f"<h2 class=\"meta\">{_e(title)}</h2>"
                f"<table class=\"metrics\" data-section=\"{_e(title)}\">"
                f"{_kv_rows(d)}</table>")
    sections = []
    flat = {}
    for key, val in metrics.items():
        if key == "telemetry":
            continue            # rendered as the latency panel below
        if isinstance(val, dict):
            sections.append(table(key, val))
        else:
            flat[key] = val
    body = (latency_panel(metrics.get("telemetry") or {})
            + resources_panel(resources or {})
            + qos_panel(qos or {})
            + kv_panel(kv or {})
            + chaos_panel(chaos or {})
            + fleet_panel(fleet or {})
            + sim_panel(sim or {})
            + timeline_panel(timeline or {})
            + introspect_panel(profile or {})
            + quality_panel(quality or {})
            + spec_panel((quality or {}).get("speculative") or {})
            + (table("runtime", flat) if flat else "")
            + "".join(sections)
            + not_ported_panel(not_ported or {}))
    return _page("telemetry", body, refresh=10)


def not_ported_panel(not_ported: dict) -> str:
    """The planes whose modules this package has not got, each with the
    ROADMAP item that ports it (their API routes answer 501)."""
    if not not_ported:
        return ""
    rows = "".join(f"<li class=\"not-ported\" data-plane=\"{_e(k)}\">"
                   f"{_e(k)}: {_e(v)}</li>"
                   for k, v in sorted(not_ported.items()))
    return (f"<h2 class=\"meta\">not ported</h2>"
            f"<ul id=\"not-ported\">{rows}</ul>")
