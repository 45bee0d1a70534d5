"""World-facing action executors: fetch_web, call_api, call_mcp,
answer_engine, generate_images.

Parity targets (reference files):
  fetch_web     — actions/web.ex:12-36 (fetch → HTML-to-Markdown, image
                  content-type handling, optional SSRF check, truncation)
  call_api      — actions/api.ex + api/ submodules (REST + JSON-RPC +
                  GraphQL adapters, auth handling, response parsing)
  call_mcp      — actions/mcp.ex:1-20 (tool invocation through the MCP
                  client, 120s default timeout)
  answer_engine — actions/answer_engine.ex:1-52 (web-grounded answers with
                  source extraction + cost recording; the reference grounds
                  through a hosted grounding model — here grounding is an
                  optional search fetch + the designated on-device answer
                  model)
  generate_images — actions/generate_images.ex + models/image_query.ex
                  (multi-image generation with cost recording)

Network I/O rides the injectable HTTP seam (infra/http.py); results are
NO_EXECUTE-fenced by the Core before entering model history.

The PyTorch port's copy of ``quoracle_tpu/actions/world.py``.
"""

from __future__ import annotations

import asyncio
import base64
import json
from decimal import Decimal
from typing import Any, Optional

from quoracle_tpu_torch.actions.executors import ActionError, register
from quoracle_tpu_torch.actions.router import truncate_output
from quoracle_tpu_torch.infra.http import SSRFError, check_ssrf
from quoracle_tpu_torch.utils.html_md import html_to_markdown

FETCH_MAX_CHARS = 50_000
IMAGE_MAX_BYTES = 512_000


async def _http(core, url: str, method: str = "GET", headers=None,
                body: Optional[bytes] = None,
                timeout_s: float = 30.0):
    """Run the (blocking) HTTP transport off-loop. When the SSRF guard is
    on, it also re-checks every redirect hop (transports that don't accept
    verify_url — test fakes — don't follow redirects anyway)."""
    fn = core.deps.http
    if fn is None:
        raise ActionError("no HTTP transport configured (zero-egress mode)")
    loop = asyncio.get_running_loop()
    kwargs = {}
    if core.deps.ssrf_check and fn is _default_transport():
        kwargs["verify_url"] = check_ssrf
    return await loop.run_in_executor(
        None, lambda: fn(url, method, headers or {}, body, timeout_s,
                         **kwargs))


def _default_transport():
    from quoracle_tpu_torch.infra.http import urllib_http
    return urllib_http


# ---------------------------------------------------------------------------
# fetch_web
# ---------------------------------------------------------------------------

@register("fetch_web")
async def fetch_web_action(core, router, params: dict) -> dict:
    url = params["url"]
    if core.deps.ssrf_check:
        # Off-loop: the guard resolves DNS, which must never block the
        # runtime loop. The default transport re-checks redirect hops.
        try:
            await asyncio.get_running_loop().run_in_executor(
                None, check_ssrf, url)
        except SSRFError as e:
            raise ActionError(f"fetch_web blocked: {e}")
    resp = await _http(core, url,
                       timeout_s=float(params.get("timeout") or 30))
    ctype = resp.content_type
    if ctype.startswith("image/"):
        # Image responses return as base64 for multimodal use (reference
        # web.ex image content-type handling), capped so one large image
        # can't blow the context window (the reference compresses via
        # libvips; our resize path is the native image preprocessor).
        if len(resp.body) > IMAGE_MAX_BYTES:
            return {"status": "ok", "url": resp.url or url,
                    "content_type": ctype, "bytes": len(resp.body),
                    "note": (f"image is {len(resp.body)} bytes "
                             f"(> {IMAGE_MAX_BYTES} cap); not inlined")}
        return {"status": "ok", "url": resp.url or url, "content_type": ctype,
                "image_base64": base64.b64encode(resp.body).decode(),
                "bytes": len(resp.body)}
    text = resp.text()
    if "html" in ctype or text.lstrip()[:1] == "<":
        content = html_to_markdown(text)
    else:
        content = text
    return {"status": "ok", "url": resp.url or url,
            "http_status": resp.status, "content_type": ctype,
            "content": truncate_output(content, FETCH_MAX_CHARS)}


# ---------------------------------------------------------------------------
# call_api (REST / JSON-RPC / GraphQL)
# ---------------------------------------------------------------------------

def _auth_headers(auth: Optional[dict],
                  core: Optional[object] = None) -> dict[str, str]:
    if not auth:
        return {}
    kind = auth.get("type", "bearer")
    if kind == "credential":
        # stored-credential auth (reference CredentialManager: encrypted
        # at rest, decrypted on fetch, access audited): the action names a
        # credential id instead of carrying the secret inline — keys never
        # pass through the model's context
        store = getattr(getattr(core, "deps", None), "credentials", None)
        if store is None:
            raise ActionError("no credential store is wired")
        data = store.get(auth.get("id", ""),
                         agent_id=getattr(core, "agent_id", ""),
                         action="call_api")
        if data is None:
            raise ActionError(
                f"unknown credential {auth.get('id')!r}")
        auth = data                            # payload is an auth dict
    from quoracle_tpu_torch.infra.http import build_auth_headers
    try:
        return build_auth_headers(auth)
    except ValueError as e:
        raise ActionError(str(e))


@register("call_api")
async def call_api_action(core, router, params: dict) -> dict:
    url = params["url"]
    method = params["method"].upper()
    protocol = params.get("protocol") or "rest"
    headers = {**(params.get("headers") or {}),
               **_auth_headers(params.get("auth"), core)}
    body_param = params.get("body")
    body: Optional[bytes] = None

    if protocol == "jsonrpc":
        method = "POST"
        payload = {"jsonrpc": "2.0", "id": 1,
                   "method": (body_param or {}).get("method"),
                   "params": (body_param or {}).get("params", {})}
        body = json.dumps(payload).encode()
        headers.setdefault("content-type", "application/json")
    elif protocol == "graphql":
        method = "POST"
        payload = {"query": (body_param or {}).get("query", ""),
                   "variables": (body_param or {}).get("variables", {})}
        body = json.dumps(payload).encode()
        headers.setdefault("content-type", "application/json")
    elif body_param is not None:
        body = json.dumps(body_param).encode()
        headers.setdefault("content-type", "application/json")

    resp = await _http(core, url, method, headers, body,
                       timeout_s=float(params.get("timeout") or 30))
    out: dict[str, Any] = {"status": "ok", "http_status": resp.status,
                           "url": url}
    text = resp.text()
    try:
        parsed = json.loads(text)
        if protocol == "jsonrpc" and isinstance(parsed, dict):
            if parsed.get("error"):
                out["error_detail"] = parsed["error"]
            parsed = parsed.get("result", parsed)
        if protocol == "graphql" and isinstance(parsed, dict):
            if parsed.get("errors"):
                out["error_detail"] = parsed["errors"]
            parsed = parsed.get("data", parsed)
        out["body"] = parsed
    except json.JSONDecodeError:
        out["body"] = truncate_output(text, FETCH_MAX_CHARS)
    if resp.status >= 400:
        out["status"] = "error"
        out["error"] = f"HTTP {resp.status}"
    return out


# ---------------------------------------------------------------------------
# call_mcp
# ---------------------------------------------------------------------------

@register("call_mcp")
async def call_mcp_action(core, router, params: dict) -> dict:
    from quoracle_tpu_torch.infra.mcp import MCPError
    mcp = core.deps.mcp
    if mcp is None:
        raise ActionError("no MCP servers configured")
    try:
        result = await mcp.call_tool(
            params["server"], params["tool"], params.get("arguments") or {},
            timeout_s=float(params["timeout"]) if params.get("timeout")
            else None, agent_id=core.agent_id)
    except (MCPError, asyncio.TimeoutError) as e:
        # surface the server's captured stderr tail into the agent-visible
        # error (reference error_context.ex) — a dying stdio server's last
        # words are usually the whole diagnosis
        ctx = mcp.error_context(params["server"])
        extra = f"\nserver stderr tail:\n{ctx}" if (
            ctx and "stderr tail" not in str(e)) else ""
        raise ActionError(f"call_mcp failed: {e}{extra}")
    # MCP results carry a content list; flatten text parts for the history
    content = (result or {}).get("content", [])
    texts = [c.get("text", "") for c in content if c.get("type") == "text"]
    raw = None
    if not texts:
        # Non-text content (screenshots, resources) can be megabytes of
        # base64 — cap it like every other world-facing payload.
        from quoracle_tpu_torch.utils.normalize import to_json
        raw = truncate_output(to_json(result), FETCH_MAX_CHARS)
    return {"status": "error" if (result or {}).get("isError") else "ok",
            "server": params["server"], "tool": params["tool"],
            "content": truncate_output("\n".join(texts), FETCH_MAX_CHARS),
            "raw": raw}


# ---------------------------------------------------------------------------
# answer_engine
# ---------------------------------------------------------------------------

ANSWER_SOURCE_CHARS = 8_000      # per-source extraction cap
ANSWER_CONTEXT_CHARS = 28_000    # whole grounding block cap
_HREF = None                     # compiled lazily (regex import cost)


def _extract_result_links(html: str, base_url: str,
                          max_links: int) -> list[dict]:
    """Top-k result links from a search page: absolute http(s) hrefs (plus
    relative ones joined against the search URL), same-host navigation
    links dropped, deduped in page order, anchor text kept as the source
    title. Regex extraction — the HTTP seam's test fakes and real search
    pages both serve plain anchors."""
    global _HREF
    import re
    import urllib.parse
    if _HREF is None:
        _HREF = re.compile(
            r'<a\s[^>]*href=["\']([^"\']+)["\'][^>]*>(.*?)</a>',
            re.IGNORECASE | re.DOTALL)
    search_host = urllib.parse.urlparse(base_url).netloc
    out, seen = [], set()
    for href, anchor in _HREF.findall(html):
        # keep fragment-bearing result links; the fragment itself is
        # stripped (same page) so #-variants dedupe together
        url, _ = urllib.parse.urldefrag(
            urllib.parse.urljoin(base_url, href.strip()))
        parsed = urllib.parse.urlparse(url)
        if parsed.scheme not in ("http", "https"):
            continue
        if parsed.netloc == search_host or not parsed.netloc:
            continue                      # search-engine nav/self links
        if url in seen:
            continue
        seen.add(url)
        title = re.sub(r"<[^>]+>", "", anchor).strip()[:200]
        out.append({"url": url, "title": title})
        if len(out) >= max_links:
            break
    return out


@register("answer_engine")
async def answer_engine_action(core, router, params: dict) -> dict:
    """Grounded Q&A with PER-SOURCE extraction and citations (reference
    answer_engine.ex:1-52 — provider-side search grounding with source
    metadata): the search template's result page yields top-k result
    URLs, each is fetched CONCURRENTLY and extracted to markdown, the
    numbered source sections ground the on-device answer model, and the
    result carries per-source citation metadata. A search page with no
    extractable result links degrades to the old single-context mode
    (the page itself as grounding)."""
    from quoracle_tpu_torch.models.runtime import QueryRequest
    query = params["query"]
    deps = core.deps
    sources: list[dict] = []
    context = ""
    numbered_grounding = False      # context holds "[n] ..." sections
    search_url = None
    max_sources = 3
    if deps.persistence is not None:
        search_url = deps.persistence.get_setting("answer_engine_search_url")
        try:
            max_sources = int(deps.persistence.get_setting(
                "answer_engine_max_sources") or 3)
        except (TypeError, ValueError):
            max_sources = 3
    if search_url and deps.http is not None:
        import urllib.parse
        url = search_url.replace("{query}", urllib.parse.quote(query))
        try:
            resp = await _http(core, url, timeout_s=20)
            page = resp.text() if resp.status < 400 else ""
        except Exception:
            page = ""
        links = (_extract_result_links(page, url, max_sources)
                 if page else [])

        async def fetch_one(link: dict) -> Optional[str]:
            try:
                if core.deps.ssrf_check:
                    # result links are CONTENT-DERIVED (a hostile search
                    # page could point at link-local metadata endpoints) —
                    # explicit pre-flight like fetch_web's, off-loop (DNS);
                    # _http only re-checks redirects for the default
                    # transport, so this guard must not depend on it
                    await asyncio.get_running_loop().run_in_executor(
                        None, check_ssrf, link["url"])
                r = await _http(core, link["url"], timeout_s=15)
                if r.status >= 400:
                    return None
                body = r.text()
                if "html" in r.content_type or body.lstrip()[:1] == "<":
                    body = html_to_markdown(body)
                return truncate_output(body, ANSWER_SOURCE_CHARS)
            except Exception:
                return None

        if links:
            extracts = await asyncio.gather(*(fetch_one(l) for l in links))
            blocks = []
            for i, (link, text) in enumerate(zip(links, extracts), 1):
                fetched = text is not None
                sources.append({"index": i, "url": link["url"],
                                "title": link["title"], "fetched": fetched})
                if fetched:
                    head = f"[{i}] {link['title'] or link['url']} " \
                           f"({link['url']})"
                    blocks.append(f"{head}\n{text}")
            context = truncate_output("\n\n".join(blocks),
                                      ANSWER_CONTEXT_CHARS)
            numbered_grounding = bool(blocks)
        if not context and page:
            # no result links (or every fetch failed): the search page
            # itself is the grounding, as before
            context = truncate_output(html_to_markdown(page), 20_000)
            sources = [{"index": 1, "url": url, "title": "search results",
                        "fetched": True}]
    answer_model = None
    if deps.persistence is not None:
        answer_model = deps.persistence.get_setting("answer_engine_model")
    answer_model = answer_model or core.config.model_pool[0]

    prompt = "Answer the question concisely and factually."
    if params.get("focus"):
        prompt += f" Focus: {params['focus']}."
    if numbered_grounding:
        prompt += (" Ground the answer in the numbered sources and cite "
                   "them inline as [n].")
    user = (f"Sources:\n{context}\n\nQuestion: {query}" if context
            else f"Question: {query}")
    loop = asyncio.get_running_loop()
    results = await loop.run_in_executor(None, lambda: deps.backend.query([
        QueryRequest(model_spec=answer_model, messages=[
            {"role": "system", "content": prompt},
            {"role": "user", "content": user}], temperature=0.3)]))
    res = results[0]
    if not res.ok:
        raise ActionError(f"answer engine query failed: {res.error}")
    if res.usage.cost:
        from quoracle_tpu_torch.infra.costs import CostEntry
        deps.costs.record(CostEntry(
            agent_id=core.agent_id, task_id=core.config.task_id,
            amount=Decimal(str(res.usage.cost)), cost_type="model",
            model_spec=answer_model, input_tokens=res.usage.prompt_tokens,
            output_tokens=res.usage.completion_tokens,
            description="answer_engine"))
    return {"status": "ok", "answer": res.text, "model": answer_model,
            "sources": sources}


# ---------------------------------------------------------------------------
# generate_images
# ---------------------------------------------------------------------------

@register("generate_images")
async def generate_images_action(core, router, params: dict) -> dict:
    backend = core.deps.images
    if backend is None:
        raise ActionError("no image backend configured")
    loop = asyncio.get_running_loop()
    try:
        images = await loop.run_in_executor(None, lambda: backend.generate(
            params["prompt"], count=int(params.get("count") or 1),
            size=params.get("size") or "256x256",
            out_dir=core.config.working_dir))
    except ValueError as e:
        raise ActionError(str(e))
    total_cost = sum(i.cost for i in images)
    if total_cost:
        from quoracle_tpu_torch.infra.costs import CostEntry
        core.deps.costs.record(CostEntry(
            agent_id=core.agent_id, task_id=core.config.task_id,
            amount=Decimal(str(total_cost)), cost_type="image",
            description=f"generate_images x{len(images)}"))
    return {"status": "ok",
            "images": [{"path": i.path, "model": i.model,
                        "width": i.width, "height": i.height}
                       for i in images]}
