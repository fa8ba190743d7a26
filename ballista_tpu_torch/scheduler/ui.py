"""Scheduler web UI: a single-page dashboard over the REST API.

Reference analog: the React/Chakra UI (``arrow-ballista: ballista/scheduler/
ui/``, cluster summary + executor list + query list with progress and
per-query STAGE drill-down views). Served at ``/`` and ``/ui`` by the API
server; polls /api/state, /api/executors, /api/jobs; clicking a job expands
its stage table from /api/stages/{job_id}. The executor table shows each
executor's registered device (a card's name; "host" for a host engine).
"""

UI_HTML = """<!doctype html>
<html><head><meta charset="utf-8"><title>ballista-tpu scheduler</title>
<style>
 body { font-family: -apple-system, Segoe UI, sans-serif; margin: 2rem; color: #1a202c; }
 h1 { font-size: 1.4rem; } h2 { font-size: 1.1rem; margin-top: 1.5rem; }
 table { border-collapse: collapse; width: 100%; margin-top: .5rem; }
 th, td { text-align: left; padding: .35rem .6rem; border-bottom: 1px solid #e2e8f0; font-size: .9rem; }
 th { background: #f7fafc; }
 .pill { padding: .1rem .5rem; border-radius: 999px; font-size: .8rem; }
 .RUNNING { background: #bee3f8; } .SUCCESSFUL { background: #c6f6d5; }
 .FAILED { background: #fed7d7; } .QUEUED { background: #edf2f7; }
 .UNRESOLVED { background: #edf2f7; } .RESOLVED { background: #e9d8fd; }
 .CANCELLED { background: #e2e8f0; } .active { background: #c6f6d5; }
 .terminating { background: #feebc8; } .quarantined { background: #fed7d7; }
 .probation { background: #feebc8; } .bar { background:#e2e8f0; border-radius:4px; height:8px; width:120px; }
 .fill { background:#3182ce; height:8px; border-radius:4px; }
 #summary span { margin-right: 1.5rem; }
 .joblink { cursor: pointer; color: #2b6cb0; text-decoration: underline dotted; }
 .stages td { background: #fbfdff; font-size: .85rem; }
 .stages table { margin: .3rem 0 .6rem 1.2rem; width: calc(100% - 1.2rem); }
 details.plan pre { background:#f7fafc; padding:.5rem; overflow-x:auto; font-size:.78rem; }
 td.metrics { font-size: .78rem; color: #4a5568; }
</style></head>
<body>
<h1>ballista-tpu scheduler</h1>
<div id="summary"></div>
<h2>Executors</h2><table id="executors"></table>
<h2>Scale</h2><div id="scale"></div>
<h2>Serving</h2><div id="serving"></div><table id="tenants"></table>
<h2>Jobs</h2><table id="jobs"></table>
<script>
async function j(p) { const r = await fetch(p); return r.json(); }
function esc(s) { return String(s).replace(/[&<>]/g, c => ({'&':'&amp;','<':'&lt;','>':'&gt;'}[c])); }
async function refresh() {
  try {
    const [state, execs, jobs, serving, scale] = await Promise.all([
      j('/api/state'), j('/api/executors'), j('/api/jobs'), j('/api/serving'),
      j('/api/scale')]);
    const sig = scale.signal, ctl = scale.controller;
    document.getElementById('scale').innerHTML =
      `<span>backlog <b>${sig.pressure}</b> (${sig.queued_tasks} queued, ` +
      `${sig.running_tasks} running, ${sig.admission_queued} admission)</span>` +
      ` &nbsp; <span>capacity <b>${sig.live_slots}</b> slots / ` +
      `${sig.live_executors} executors (occ ${Math.round(sig.occupancy*100)}%)</span>` +
      ` &nbsp; <span>desired <b>${sig.desired_executors}</b>` +
      `${ctl.enabled ? '' : ' (controller passive)'}</span>` +
      `${sig.draining_executors ? ` &nbsp; <span class="pill terminating">draining ${sig.draining_executors}</span>` : ''}`;
    const pc = serving.plan_cache, adm = serving.admission,
          xc = serving.exchange_cache || {};
    document.getElementById('serving').innerHTML =
      `<span>plan cache <b>${pc.hits}</b> hits / <b>${pc.misses}</b> misses` +
      ` (${pc.entries}/${pc.capacity} entries, ${pc.evictions} evicted)</span>` +
      ` &nbsp; <span>exchange cache <b>${xc.hits||0}</b> hits / ` +
      `<b>${xc.misses||0}</b> misses (${xc.entries||0} entries, ` +
      `${xc.tasks_skipped||0} tasks skipped, ` +
      `${Math.round((xc.bytes||0)/1048576)} MiB pinned)</span>` +
      ` &nbsp; <span>admission queue <b>${adm.queue_depth}</b>` +
      ` (running ${adm.running_jobs}, rejected ${adm.rejected_total})</span>`;
    const tenants = Object.entries(serving.tenants || {});
    document.getElementById('tenants').innerHTML = tenants.length ?
      '<tr><th>tenant</th><th>running slots</th><th>offered tasks</th></tr>' +
      tenants.map(([t, v]) => `<tr><td>${esc(t)}</td>` +
        `<td>${v.running_slots}</td><td>${v.offered_tasks}</td></tr>`).join('') : '';
    document.getElementById('summary').innerHTML =
      `<span>scheduler <b>${esc(state.started)}</b></span>` +
      `<span>version <b>${esc(state.version)}</b></span>` +
      `<span>executors <b>${state.executors}</b></span>` +
      `<span>active jobs <b>${state.active_jobs}</b></span>`;
    document.getElementById('executors').innerHTML =
      '<tr><th>id</th><th>host</th><th>flight</th><th>device</th><th>slots</th><th>status</th><th>health</th><th>last seen</th></tr>' +
      execs.map(e => `<tr><td>${esc(e.executor_id)}</td><td>${esc(e.host)}:${e.port}</td>` +
        `<td>${e.flight_port}</td><td>${esc(e.device_kind || 'host')}</td>` +
        `<td>${e.free_slots}/${e.task_slots}</td>` +
        `<td><span class="pill ${esc(e.status)}">${esc(e.status)}</span></td>` +
        `<td><span class="pill ${esc(e.quarantine_state || 'active')}">${esc(e.quarantine_state || 'active')}</span>` +
        `${e.quarantine_state === 'quarantined' ? ' ' + Math.round(e.quarantine_remaining_s || 0) + 's' : ''}</td>` +
        `<td>${Math.round(Date.now()/1000 - e.last_seen_ts)}s ago</td></tr>`).join('');
    const open = new Set([...document.querySelectorAll('tr.stages')].map(r => r.dataset.job));
    document.getElementById('jobs').innerHTML =
      '<tr><th>job</th><th>name</th><th>status</th><th>stages</th><th>progress</th><th>plan</th></tr>' +
      jobs.map(g => {
        const stages = Object.values(g.stages);
        const total = stages.reduce((a, s) => a + s.partitions, 0);
        const done = stages.reduce((a, s) => a + s.completed, 0);
        const pct = total ? Math.round(100 * done / total) : 0;
        return `<tr><td><span class="joblink" onclick="toggleStages('${esc(g.job_id)}')">${esc(g.job_id)}</span></td>` +
          `<td>${esc(g.job_name || '')}</td>` +
          `<td><span class="pill ${esc(g.status)}">${esc(g.status)}</span></td>` +
          `<td>${stages.length}</td>` +
          `<td><div class="bar"><div class="fill" style="width:${pct}%"></div></div> ${done}/${total}</td>` +
          `<td><a href="/api/dot/${esc(g.job_id)}">dot</a></td></tr>`;
      }).join('');
    for (const jid of open) await toggleStages(jid, true);
  } catch (e) { console.error(e); }
}
// per-job stage drill-down (reference: the React UI's stage views)
async function toggleStages(jobId, forceOpen) {
  const jobsTable = document.getElementById('jobs');
  const existing = jobsTable.querySelector(`tr.stages[data-job="${jobId}"]`);
  if (existing && !forceOpen) { existing.remove(); return; }
  if (existing) existing.remove();
  const stages = await j('/api/stages/' + jobId);
  const keyMetrics = m => ['rows', 'exec_time_s', 'op.CompiledStage.time_s']
    .filter(k => m[k] !== undefined)
    .map(k => `${k}=${m[k]}`).join(' ');
  const rows = Object.entries(stages).map(([sid, s]) =>
    `<tr><td>${esc(sid)}</td>` +
    `<td><span class="pill ${esc(s.state)}">${esc(s.state)}</span></td>` +
    `<td>${s.attempt}</td>` +
    `<td>${s.completed}/${s.partitions}${s.running ? ` (${s.running} running)` : ''}</td>` +
    `<td>${s.task_failures}</td>` +
    `<td class="metrics">${esc(keyMetrics(s.metrics))}</td>` +
    `<td><details class="plan"><summary>plan</summary><pre>${esc(s.plan)}</pre></details></td></tr>`
  ).join('');
  const tr = document.createElement('tr');
  tr.className = 'stages';
  tr.dataset.job = jobId;
  tr.innerHTML = `<td colspan="6"><table>` +
    `<tr><th>stage</th><th>state</th><th>attempt</th><th>tasks</th><th>failures</th><th>metrics</th><th></th></tr>` +
    rows + `</table></td>`;
  const anchor = [...jobsTable.rows].find(r =>
    r.cells[0] && r.cells[0].textContent === jobId);
  if (anchor) anchor.after(tr);
}
refresh(); setInterval(refresh, 2000);
</script></body></html>
"""
