"""The dashboard single page: 3-panel layout parity with the reference
(reference lib/quoracle_web/live/dashboard_live.ex + README.md:624 — task
tree left, log viewer middle, mailbox right), rendered client-side from the
JSON API and kept live by the /events SSE stream.

The PyTorch port's copy of ``quoracle_tpu/web/page.py``: the same page."""

DASHBOARD_HTML = r"""<!doctype html>
<html lang="en">
<head>
<meta charset="utf-8">
<title>quoracle-tpu</title>
<style>
  :root { color-scheme: dark; }
  * { box-sizing: border-box; }
  body { margin: 0; font: 13px/1.5 ui-monospace, SFMono-Regular, Menlo,
         monospace; background: #14161a; color: #d6d8dd; }
  header { display: flex; align-items: center; gap: 16px;
           padding: 10px 16px; border-bottom: 1px solid #2a2d33; }
  header h1 { font-size: 14px; margin: 0; color: #fff; font-weight: 600; }
  header .status { color: #8b8f98; }
  main { display: grid; grid-template-columns: 300px 1fr 340px;
         height: calc(100vh - 45px); }
  section { overflow-y: auto; padding: 12px; border-right: 1px solid #2a2d33; }
  section h2 { font-size: 11px; text-transform: uppercase; letter-spacing:
               .08em; color: #8b8f98; margin: 0 0 8px; }
  .task { padding: 6px 8px; border-radius: 6px; cursor: pointer;
          margin-bottom: 4px; }
  .task:hover, .task.sel { background: #20242b; }
  .task .tid { color: #9ecbff; }
  .task .st { float: right; color: #8b8f98; }
  .agent { padding: 4px 8px; cursor: pointer; border-radius: 4px;
           white-space: nowrap; overflow: hidden; text-overflow: ellipsis; }
  .agent:hover, .agent.sel { background: #20242b; }
  .agent .aid { color: #b7e3a8; }
  .agent .meta { color: #8b8f98; }
  .log { padding: 3px 0; border-bottom: 1px solid #1c1f24;
         word-break: break-word; white-space: pre-wrap; }
  .log .lvl-error { color: #ff9a9a; }
  .log .lvl-warning { color: #ffd28a; }
  .log .lvl-decision { color: #9ecbff; }
  .log .ts { color: #5c6068; margin-right: 6px; }
  .msg { padding: 6px 8px; margin-bottom: 6px; background: #1a1d22;
         border-radius: 6px; }
  .msg .from { color: #d9b8ff; }
  form { display: flex; gap: 6px; margin-top: 10px; }
  input, button, select { font: inherit; background: #1a1d22; color: #d6d8dd;
          border: 1px solid #2a2d33; border-radius: 6px; padding: 6px 8px; }
  input { flex: 1; }
  button { cursor: pointer; }
  button:hover { background: #242830; }
  #newtask { margin-bottom: 12px; display: flex; flex-direction: column;
             gap: 6px; }
  #newtask input { width: 100%; }
  .row { display: flex; gap: 6px; }
</style>
</head>
<body>
<header>
  <h1>quoracle-tpu</h1>
  <span class="status" id="status">connecting…</span>
  <nav style="display:flex;gap:10px">
    <a href="/logs" style="color:#9ecbff">logs</a>
    <a href="/mailbox" style="color:#9ecbff">mailbox</a>
    <a href="/telemetry" style="color:#9ecbff">telemetry</a>
  </nav>
  <button id="settings-btn" style="margin-left:auto"
          onclick="toggleSettings()">settings</button>
</header>
<div id="settings-panel" style="display:none;padding:12px 16px;
     border-bottom:1px solid #333">
  <div style="display:flex;gap:28px;flex-wrap:wrap">
    <div>
      <h2>System settings</h2>
      <div id="st-settings"></div>
      <div class="row">
        <input id="st-key" placeholder="key" style="width:140px">
        <input id="st-val" placeholder="value (JSON or text)"
               style="width:180px">
        <button onclick="saveSetting()">set</button>
      </div>
    </div>
    <div>
      <h2>Profiles</h2>
      <div id="st-profiles"></div>
      <div class="row">
        <input id="pf-name" placeholder="name" style="width:110px">
        <input id="pf-pool" placeholder="model pool (comma-sep)"
               style="width:200px">
        <button onclick="saveProfile()">save</button>
      </div>
    </div>
    <div>
      <h2>Secrets <span class="meta">(values never displayed)</span></h2>
      <div id="st-secrets"></div>
      <div class="row">
        <input id="sc-name" placeholder="name" style="width:110px">
        <input id="sc-val" placeholder="value (empty = generate)"
               type="password" style="width:160px">
        <button onclick="saveSecret()">save</button>
      </div>
    </div>
    <div>
      <h2>Credentials <span class="meta">(encrypted; call_api/MCP auth)</span></h2>
      <div id="st-creds"></div>
      <div class="row">
        <input id="cr-id" placeholder="id" style="width:90px">
        <select id="cr-type" style="width:90px">
          <option value="bearer">bearer</option>
          <option value="basic">basic</option>
          <option value="header">header</option>
        </select>
        <input id="cr-val" placeholder="token / user:pass / name=value"
               type="password" style="width:170px">
        <button onclick="saveCredential()">save</button>
      </div>
    </div>
  </div>
</div>
<main>
  <section id="left">
    <div id="newtask">
      <select id="nt-grove" onchange="groveSelected()">
        <option value="">no grove (plain task)</option>
      </select>
      <div id="nt-grove-info" class="meta" style="display:none"></div>
      <input id="nt-desc" placeholder="new task description">
      <div class="row">
        <input id="nt-budget" placeholder="budget (optional)" style="width:120px">
        <button onclick="createTask()">create task</button>
      </div>
    </div>
    <h2>Tasks</h2><div id="tasks"></div>
    <h2 style="margin-top:14px">Agents</h2><div id="agents"></div>
  </section>
  <section id="mid">
    <h2>Logs <span id="log-scope" class="meta"></span></h2>
    <div id="logs"></div>
  </section>
  <section id="right" style="border-right:none">
    <h2>Todos <span id="todo-scope" class="meta"></span></h2>
    <div id="todos" class="meta" style="margin-bottom:10px"></div>
    <h2>Mailbox</h2>
    <div id="messages"></div>
    <form onsubmit="sendMessage(event)">
      <input id="msg-input" placeholder="message selected agent…">
      <button>send</button>
    </form>
  </section>
</main>
<script>
let selTask = null, selAgent = null;
const $ = id => document.getElementById(id);
const esc = s => String(s ?? "").replace(/[&<>"']/g,
  c => ({"&":"&amp;","<":"&lt;",">":"&gt;",'"':"&quot;","'":"&#39;"}[c]));
// For names interpolated into inline JS calls: JSON.stringify guards the
// JS-string context (backslash-escapes quotes), esc() guards the HTML
// attribute context around it.
const jsArg = s => esc(JSON.stringify(String(s ?? "")));

// Token-mode support: ?token=… (or #token=…) is remembered in
// sessionStorage and attached to every request; EventSource can't set
// headers, so the SSE URL carries it as a query param too.
const urlTok = new URLSearchParams(location.search).get("token")
  || new URLSearchParams(location.hash.slice(1)).get("token");
if (urlTok) {
  sessionStorage.setItem("qt_token", urlTok);
  history.replaceState(null, "", location.pathname);   // scrub from URL bar
}
const TOKEN = sessionStorage.getItem("qt_token");
const withTok = path => !TOKEN ? path
  : path + (path.includes("?") ? "&" : "?") + "token="
    + encodeURIComponent(TOKEN);

async function api(path, opts) {
  opts = opts || {};
  if (TOKEN) opts.headers = {...(opts.headers || {}),
                             "authorization": "Bearer " + TOKEN};
  const r = await fetch(path, opts);
  return r.json();
}

// -- settings surface (reference SecretManagementLive) --------------------
let settingsOpen = false;
function toggleSettings() {
  settingsOpen = !settingsOpen;
  $("settings-panel").style.display = settingsOpen ? "block" : "none";
  if (settingsOpen) refreshSettings();
}
async function refreshSettings() {
  const s = await api("/api/settings");
  $("st-settings").innerHTML = Object.entries(s.settings).map(([k, v]) =>
    `<div class="meta">${esc(k)} = ${esc(JSON.stringify(v))}</div>`)
    .join("") || '<div class="meta">none set</div>';
  $("st-profiles").innerHTML = Object.entries(s.profiles).map(([n, p]) =>
    `<div class="meta">${esc(n)}: ${esc((p.model_pool||[]).join(","))}
     <a href="#" onclick="delProfile(${jsArg(n)});return false">✕</a>
     </div>`).join("") || '<div class="meta">none</div>';
  $("st-secrets").innerHTML = s.secrets.map(x =>
    `<div class="meta">${esc(x.name)} — ${esc(x.description || "")}
     <a href="#" onclick="delSecret(${jsArg(x.name)});return false">✕</a>
     </div>`).join("") || '<div class="meta">none</div>';
  const creds = await api("/api/credentials");
  $("st-creds").innerHTML = creds.map(c =>
    `<div class="meta">${esc(c.id)}${c.model_spec
       ? " → " + esc(c.model_spec) : ""} ${c.encrypted ? "🔒" : ""}
     <a href="#" onclick="delCredential(${jsArg(c.id)});return false">✕</a>
     </div>`).join("") || '<div class="meta">none</div>';
}

async function saveCredential() {
  const type = $("cr-type").value, raw = $("cr-val").value;
  let data = {type};
  if (type === "bearer") data.token = raw;
  else if (type === "basic") {
    const i = raw.indexOf(":");
    if (i < 0) return alert("basic credentials need user:password");
    data.username = raw.slice(0, i); data.password = raw.slice(i + 1);
  } else {
    const i = raw.indexOf("=");
    if (i < 0) return alert("header credentials need name=value");
    data.name = raw.slice(0, i); data.value = raw.slice(i + 1);
  }
  await api("/api/credentials", {method: "POST",
    body: JSON.stringify({id: $("cr-id").value, data})});
  $("cr-val").value = "";
  refreshSettings();
}
async function delCredential(id) {
  await api("/api/credentials/" + encodeURIComponent(id),
            {method: "DELETE"});
  refreshSettings();
}
async function saveSetting() {
  let v = $("st-val").value;
  try { v = JSON.parse(v); } catch (e) { /* keep as string */ }
  await api("/api/settings", {method: "POST",
    body: JSON.stringify({[$("st-key").value]: v})});
  refreshSettings();
}
async function saveProfile() {
  await api("/api/profiles", {method: "POST", body: JSON.stringify({
    name: $("pf-name").value,
    model_pool: $("pf-pool").value.split(",").map(s => s.trim())
      .filter(Boolean)})});
  refreshSettings();
}
async function saveSecret() {
  await api("/api/secrets", {method: "POST", body: JSON.stringify({
    name: $("sc-name").value, value: $("sc-val").value})});
  $("sc-val").value = "";
  refreshSettings();
}
async function delProfile(n) {
  await api("/api/profiles/" + encodeURIComponent(n), {method: "DELETE"});
  refreshSettings();
}
async function delSecret(n) {
  await api("/api/secrets/" + encodeURIComponent(n), {method: "DELETE"});
  refreshSettings();
}

async function refreshTasks() {
  const tasks = await api("/api/tasks");
  $("tasks").innerHTML = tasks.map(t => `
    <div class="task ${t.id===selTask?"sel":""}" onclick="selectTask('${t.id}')">
      <span class="tid">${esc(t.id)}</span>
      <span class="st">${esc(t.status)} · ${t.live_agents} live · $${esc(t.cost)}</span>
      <div class="meta">${esc((t.task_fields||{}).description||"").slice(0,60)}</div>
      <div class="row" style="margin-top:4px">
        <button onclick="event.stopPropagation();taskOp('${t.id}','pause')">pause</button>
        <button onclick="event.stopPropagation();taskOp('${t.id}','resume')">resume</button>
      </div>
    </div>`).join("");
}

let agentIndex = {};   // agent_id -> payload row (todo panel, badges)

// Budget badge (reference budget_badge.ex): remaining escrow when the
// agent is capped, else its own spend; tree roll-up sums the subtree's
// costs client-side (CostAggregator feeds per-agent cost server-side).
function budgetBadge(a) {
  const b = a.budget;
  if (b && b.available != null) {
    const cls = parseFloat(b.available) <= 0 ? "lvl-error" : "";
    return `<span class="meta ${cls}" title="spent ${esc(b.spent)} of ` +
           `${esc(b.limit)}">⛁ ${esc(b.available)} left</span>`;
  }
  return `<span class="meta">$${esc(a.cost)}</span>`;
}

async function refreshAgents() {
  const qs = selTask ? "?task_id=" + selTask : "";
  const agents = await api("/api/agents" + qs);
  agentIndex = Object.fromEntries(agents.map(a => [a.agent_id, a]));
  const byParent = {};
  agents.forEach(a => (byParent[a.parent_id ?? ""] ??= []).push(a));
  const treeCost = a => (byParent[a.agent_id] || [])
    .reduce((s, c) => s + treeCost(c), parseFloat(a.cost) || 0);
  const render = (pid, depth) => (byParent[pid ?? ""] || []).map(a => {
    const sub = treeCost(a);
    const roll = (byParent[a.agent_id] || []).length
      ? `<span class="meta" title="subtree cost">Σ$${sub.toFixed(4)}</span>`
      : "";
    return `
    <div class="agent ${a.agent_id===selAgent?"sel":""}"
         style="padding-left:${8+depth*14}px"
         onclick="selectAgent('${a.agent_id}')">
      <span class="aid">${esc(a.agent_id)}</span>
      <span class="meta"> ${esc(a.grove_node||a.profile||"")}
        ${a.pending_actions ? "⚙" : ""}
        ${a.todos && a.todos.length ? "☰" + a.todos.length : ""}</span>
      ${budgetBadge(a)} ${roll}
    </div>` + render(a.agent_id, depth + 1);
  }).join("");
  $("agents").innerHTML = render("", 0);
  refreshTodos();
}

function refreshTodos() {
  const a = selAgent ? agentIndex[selAgent] : null;
  $("todo-scope").textContent = selAgent || "(select an agent)";
  const todos = a ? (a.todos || []) : [];
  $("todos").innerHTML = todos.length
    ? todos.map(t => {
        const item = typeof t === "string" ? {text: t} : t;
        const done = item.done || item.status === "done";
        return `<div class="log">${done ? "☑" : "☐"} ${
          esc(item.text || item.item || JSON.stringify(item))}</div>`;
      }).join("")
    : '<div class="meta">no todos</div>';
}

async function refreshLogs() {
  const qs = selAgent ? "?agent_id=" + selAgent : "";
  const logs = await api("/api/logs" + qs);
  $("log-scope").textContent = selAgent || "(all)";
  $("logs").innerHTML = logs.map(l => `
    <div class="log"><span class="ts">${new Date(l.ts*1000)
      .toLocaleTimeString()}</span><span class="lvl-${esc(l.level)}">
      [${esc(l.level)}]</span> ${esc(l.agent_id)}: ${esc(l.message)}
      ${l.data && l.data !== "{}" ? esc(l.data).slice(0, 400) : ""}</div>`)
    .join("");
  $("logs").scrollTop = $("logs").scrollHeight;
}

async function refreshMessages() {
  const qs = selTask ? "?task_id=" + selTask : "";
  const msgs = await api("/api/messages" + qs);
  $("messages").innerHTML = msgs.map(m => `
    <div class="msg"><span class="from">${esc(m.sender)}</span>
      <span class="meta">→ ${esc(m.targets)}</span>
      <div>${esc(m.content).slice(0, 500)}</div></div>`).join("");
}

function selectTask(id) { selTask = id; refreshAll(); }
function selectAgent(id) { selAgent = id; refreshLogs(); refreshTodos(); }

// -- grove selector + bootstrap pre-fill (reference new_task_modal.ex) ----
let groves = [];
async function loadGroves() {
  try { groves = await api("/api/groves"); } catch (e) { groves = []; }
  const sel = $("nt-grove");
  sel.innerHTML = '<option value="">no grove (plain task)</option>'
    + groves.map((g, i) =>
        `<option value="${i}">${esc(g.name)}</option>`).join("");
}
function groveSelected() {
  const i = $("nt-grove").value;
  const info = $("nt-grove-info");
  const desc = $("nt-desc"), budget = $("nt-budget");
  // switching groves (or back to none) must not leave the PREVIOUS
  // grove's pre-fill behind — clear anything this selector filled
  if (desc.dataset.groveFilled === "1") {
    desc.value = ""; desc.dataset.groveFilled = "";
  }
  if (budget.dataset.groveFilled === "1") {
    budget.value = ""; budget.dataset.groveFilled = "";
  }
  if (i === "") { info.style.display = "none"; return; }
  const g = groves[+i];
  const boot = g.bootstrap || {};
  // pre-fill from the grove's resolved bootstrap (never clobber text the
  // user typed themselves)
  if (!desc.value) {
    desc.value = boot.task_description || g.description || "";
    desc.dataset.groveFilled = "1";
  }
  if (boot.budget && !budget.value) {
    budget.value = boot.budget;
    budget.dataset.groveFilled = "1";
  }
  info.style.display = "block";
  info.innerHTML = `${esc(g.description || "")}`
    + (g.root_node ? ` · root node <b>${esc(g.root_node)}</b>` : "")
    + (boot.success_criteria
       ? `<div title="${esc(boot.success_criteria)}">success criteria: ${
          esc(String(boot.success_criteria).slice(0, 120))}…</div>` : "");
}

async function taskOp(id, op) { await api(`/api/tasks/${id}/${op}`,
  {method: "POST"}); refreshAll(); }

async function createTask() {
  const body = {description: $("nt-desc").value};
  const budget = $("nt-budget").value;
  if (budget) body.budget = budget;
  const gi = $("nt-grove").value;
  if (gi !== "") body.grove = groves[+gi].dir;
  await api("/api/tasks", {method: "POST",
    headers: {"content-type": "application/json"},
    body: JSON.stringify(body)});
  $("nt-desc").value = "";
  $("nt-desc").dataset.groveFilled = "";
  $("nt-budget").value = "";
  $("nt-budget").dataset.groveFilled = "";
  $("nt-grove").value = "";
  $("nt-grove-info").style.display = "none";
  refreshAll();
}

async function sendMessage(ev) {
  ev.preventDefault();
  if (!selAgent) return alert("select an agent first");
  await api("/api/messages", {method: "POST",
    headers: {"content-type": "application/json"},
    body: JSON.stringify({agent_id: selAgent,
                          content: $("msg-input").value})});
  $("msg-input").value = "";
}

function refreshAll() { refreshTasks(); refreshAgents(); refreshLogs();
                        refreshMessages(); }

const es = new EventSource(withTok("/events"));
es.onopen = () => $("status").textContent = "live";
es.onerror = () => $("status").textContent = "reconnecting…";
let pending = null;
es.onmessage = () => {        // debounce bursts into one refresh
  if (pending) return;
  pending = setTimeout(() => { pending = null; refreshAll(); }, 250);
};
loadGroves();
refreshAll();
</script>
</body>
</html>
"""
