"""The control plane's ``GET /dashboard`` page.

One self-contained HTML document — no external assets, no frameworks —
served verbatim by :mod:`repro_torch.control.http_api` and polling
``/metrics.json`` every 2 s from the browser. It shows the four things
an operator actually reaches for:

* **queue/jobs** — scheduler depth, job counts by outcome, hit rates;
* **stage latency** — p50/p99 per pipeline stage (queue → store →
  plan → execute → total, plus streaming updates);
* **model health** — perf-model drift ratio per pipeline kind and
  applied retunes;
* **pipeline utilization** — the profiler's achieved GB/s and
  %-of-peak bars per pipeline kind and per lane (repro_torch.obs.profile),
  the port's analogue of ReGraph's per-channel bandwidth plots.

Kept as a Python string (not a data file) so the package needs no
resource loading and the page is importable/testable directly.
"""
from __future__ import annotations

__all__ = ["DASHBOARD_HTML"]

DASHBOARD_HTML = """<!DOCTYPE html>
<html lang="en">
<head>
<meta charset="utf-8">
<meta name="viewport" content="width=device-width, initial-scale=1">
<title>regraph control plane</title>
<style>
  :root {
    color-scheme: light;
    --surface-1: #fcfcfb;
    --surface-2: #f0efec;
    --text-primary: #0b0b0b;
    --text-secondary: #52514e;
    --grid: #e3e2de;
    --seq: #2a78d6;        /* sequential hue: magnitude bars */
    --seq-track: #cde2fb;
    --status-good: #008300;
    --status-serious: #e34948;
  }
  @media (prefers-color-scheme: dark) {
    :root {
      color-scheme: dark;
      --surface-1: #1a1a19;
      --surface-2: #383835;
      --text-primary: #ffffff;
      --text-secondary: #c3c2b7;
      --grid: #3e3e3a;
      --seq: #3987e5;
      --seq-track: #104281;
      --status-good: #00a300;
      --status-serious: #e66767;
    }
  }
  body {
    margin: 0; padding: 20px 24px;
    background: var(--surface-1); color: var(--text-primary);
    font: 14px/1.45 system-ui, sans-serif;
  }
  h1 { font-size: 16px; font-weight: 600; margin: 0 0 2px; }
  h2 {
    font-size: 12px; font-weight: 600; letter-spacing: .04em;
    text-transform: uppercase; color: var(--text-secondary);
    margin: 0 0 10px;
  }
  .sub { color: var(--text-secondary); font-size: 12px; margin: 0 0 18px; }
  .grid { display: flex; flex-wrap: wrap; gap: 16px; }
  .card {
    background: var(--surface-1); border: 1px solid var(--grid);
    border-radius: 8px; padding: 14px 16px; min-width: 260px; flex: 1;
  }
  .tiles { display: flex; flex-wrap: wrap; gap: 16px 28px; }
  .tile .v { font-size: 24px; font-weight: 600; font-variant-numeric: tabular-nums; }
  .tile .k { font-size: 12px; color: var(--text-secondary); }
  table { border-collapse: collapse; width: 100%; }
  th {
    text-align: left; font-size: 11px; font-weight: 600;
    color: var(--text-secondary); padding: 3px 10px 3px 0;
    border-bottom: 1px solid var(--grid);
  }
  th.num, td.num { text-align: right; font-variant-numeric: tabular-nums; }
  td { padding: 3px 10px 3px 0; border-bottom: 1px solid var(--surface-2); }
  tr:last-child td { border-bottom: none; }
  .bar-row { display: flex; align-items: center; gap: 8px; margin: 5px 0; }
  .bar-label {
    flex: 0 0 92px; font-size: 12px; color: var(--text-secondary);
    white-space: nowrap; overflow: hidden; text-overflow: ellipsis;
  }
  .bar-track {
    flex: 1; height: 10px; background: var(--surface-2);
    border-radius: 4px; overflow: hidden;
  }
  .bar-fill {
    height: 100%; background: var(--seq);
    border-radius: 0 4px 4px 0; min-width: 2px;
  }
  .bar-val {
    flex: 0 0 120px; font-size: 12px; text-align: right;
    font-variant-numeric: tabular-nums;
  }
  .dot {
    display: inline-block; width: 8px; height: 8px; border-radius: 50%;
    margin-right: 6px; vertical-align: baseline;
  }
  .ok .dot { background: var(--status-good); }
  .bad .dot { background: var(--status-serious); }
  .muted { color: var(--text-secondary); }
  #err { color: var(--status-serious); font-size: 12px; min-height: 16px; }
</style>
</head>
<body>
<h1>regraph control plane</h1>
<p class="sub">
  <span id="ready" class="ok"><span class="dot"></span>ready</span>
  &nbsp;&middot;&nbsp; polls <code>/metrics.json</code> every 2 s
  &nbsp;&middot;&nbsp; <span id="updated" class="muted">never updated</span>
</p>
<div id="err"></div>
<div class="grid">
  <div class="card" style="flex:2 1 420px">
    <h2>Queue &amp; jobs</h2>
    <div class="tiles" id="tiles"></div>
  </div>
  <div class="card">
    <h2>Stage latency (ms)</h2>
    <table>
      <thead><tr><th>stage</th><th class="num">p50</th>
        <th class="num">p99</th></tr></thead>
      <tbody id="latency"></tbody>
    </table>
  </div>
  <div class="card">
    <h2>Perf-model drift</h2>
    <table>
      <thead><tr><th>kind</th><th class="num">ratio</th>
        <th class="num">samples</th></tr></thead>
      <tbody id="drift"></tbody>
    </table>
    <p class="muted" style="font-size:12px;margin:8px 0 0">
      measured / estimated lane time; 1.00 = model exact.
      retunes applied: <span id="retunes">0</span></p>
  </div>
  <div class="card" style="flex:2 1 420px">
    <h2>Pipeline utilization</h2>
    <div id="util-kinds"></div>
    <p class="muted" style="font-size:12px;margin:10px 0 4px">
      per lane (last sample; fraction of
      <span id="peak">?</span> GB/s peak)</p>
    <div id="util-lanes"></div>
  </div>
</div>
<script>
"use strict";
const $ = id => document.getElementById(id);
const fmt = (x, d=1) => (x === null || x === undefined || isNaN(x))
  ? "\\u2013" : Number(x).toFixed(d);

function tile(k, v) {
  return `<div class="tile"><div class="v">${v}</div>` +
         `<div class="k">${k}</div></div>`;
}

function bar(label, frac, valText) {
  const pct = Math.max(0, Math.min(1, frac || 0)) * 100;
  return `<div class="bar-row"><div class="bar-label">${label}</div>` +
    `<div class="bar-track"><div class="bar-fill" ` +
    `style="width:${pct.toFixed(1)}%"></div></div>` +
    `<div class="bar-val">${valText}</div></div>`;
}

function render(d) {
  const s = d.service || {};
  const sched = d.scheduler || {};
  const jobs = d.jobs || {};
  const by = jobs.by_state || {};
  $("tiles").innerHTML =
    tile("queue depth", sched.depth ?? s.queue_depth ?? 0) +
    tile("submitted", s.submitted ?? 0) +
    tile("completed", s.completed ?? 0) +
    tile("failed", s.failed ?? 0) +
    tile("running jobs", by.running ?? 0) +
    tile("store hit rate", fmt((s.store_hit_rate ?? 0) * 100, 0) + "%") +
    tile("plan hit rate", fmt((s.plan_hit_rate ?? 0) * 100, 0) + "%");
  const stages = ["queue", "store", "plan", "execute", "total", "update"];
  $("latency").innerHTML = stages.map(st =>
    `<tr><td>${st}</td><td class="num">${fmt(s["p50_" + st + "_ms"], 2)}` +
    `</td><td class="num">${fmt(s["p99_" + st + "_ms"], 2)}</td></tr>`
  ).join("");
  const drift = s.drift || {};
  const dk = Object.keys(drift).sort();
  $("drift").innerHTML = dk.length ? dk.map(k =>
    `<tr><td>${k}</td><td class="num">${fmt(drift[k].ratio, 3)}</td>` +
    `<td class="num">${drift[k].n ?? 0}</td></tr>`).join("")
    : '<tr><td colspan="3" class="muted">no samples yet</td></tr>';
  $("retunes").textContent = s.retunes ?? 0;
  const util = s.utilization || {};
  const kinds = util.kinds || {};
  const peak = util.peak_bandwidth_gbps;
  $("peak").textContent = fmt(peak, 1);
  const kk = Object.keys(kinds).sort();
  $("util-kinds").innerHTML = kk.length ? kk.map(k => {
    const r = kinds[k];
    const u = r.utilization;
    return bar(k, u ?? (peak ? r.gbps / peak : 0),
      `${fmt(r.gbps, 2)} GB/s` +
      (u !== null && u !== undefined ? ` \\u00b7 ${fmt(u * 100, 1)}%` : ""));
  }).join("") : '<p class="muted" style="font-size:12px">no samples yet</p>';
  const lanes = util.lanes || {};
  const lk = Object.keys(lanes).sort((a, b) => a - b);
  $("util-lanes").innerHTML = lk.length ? lk.map(l => {
    const r = lanes[l];
    const u = r.utilization;
    return bar(`lane ${l} (${r.kind})`,
      u ?? (peak ? r.gbps / peak : 0),
      `${fmt(r.gbps, 2)} GB/s` +
      (u !== null && u !== undefined ? ` \\u00b7 ${fmt(u * 100, 1)}%` : ""));
  }).join("") : '<p class="muted" style="font-size:12px">no samples yet</p>';
}

async function tick() {
  try {
    const [m, r] = await Promise.all([
      fetch("/metrics.json").then(x => x.json()),
      fetch("/readyz").then(x => x.json()).catch(() => null),
    ]);
    render(m);
    if (r) {
      const el = $("ready");
      el.className = r.ready ? "ok" : "bad";
      el.innerHTML = '<span class="dot"></span>' +
        (r.ready ? "ready" : "not ready");
    }
    $("updated").textContent =
      "updated " + new Date().toLocaleTimeString();
    $("err").textContent = "";
  } catch (e) {
    $("err").textContent = "poll failed: " + e;
  }
}
tick();
setInterval(tick, 2000);
</script>
</body>
</html>
"""
