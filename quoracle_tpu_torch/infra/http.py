"""HTTP transport seam + SSRF guard.

The reference reaches the web through Req/Finch with an optional SSRF check
on fetch_web (reference lib/quoracle/actions/web.ex:12-36). Here the
transport is one injectable callable — tests and the zero-egress build
environment swap in fakes, production uses urllib. Every world-facing
action (fetch_web, call_api, answer_engine grounding) goes through this
seam; nothing else in the framework may open sockets.

The PyTorch port's copy of ``quoracle_tpu/infra/http.py``.
"""

from __future__ import annotations

import dataclasses
import ipaddress
import socket
import urllib.error
import urllib.parse
import urllib.request
from typing import Callable, Mapping, Optional

DEFAULT_TIMEOUT_S = 30.0
MAX_RESPONSE_BYTES = 5_000_000


@dataclasses.dataclass
class HttpResponse:
    status: int
    headers: dict[str, str]
    body: bytes
    url: str = ""

    def text(self) -> str:
        return self.body.decode("utf-8", errors="replace")

    @property
    def content_type(self) -> str:
        return self.headers.get("content-type", "").split(";")[0].strip()


# (url, method, headers, body, timeout_s) -> HttpResponse
HttpFn = Callable[..., HttpResponse]


class SSRFError(ValueError):
    pass


def check_ssrf(url: str) -> None:
    """Reject URLs resolving to private/loopback/link-local ranges
    (reference web.ex optional SSRF check)."""
    parsed = urllib.parse.urlparse(url)
    if parsed.scheme not in ("http", "https"):
        raise SSRFError(f"unsupported scheme {parsed.scheme!r}")
    host = parsed.hostname
    if not host:
        raise SSRFError("URL has no host")
    try:
        infos = socket.getaddrinfo(host, None)
    except socket.gaierror as e:
        raise SSRFError(f"cannot resolve {host!r}: {e}")
    for info in infos:
        addr = ipaddress.ip_address(info[4][0])
        if (addr.is_private or addr.is_loopback or addr.is_link_local
                or addr.is_reserved or addr.is_multicast):
            raise SSRFError(f"{host!r} resolves to non-public {addr}")


def build_auth_headers(auth: dict) -> dict[str, str]:
    """Auth payload dict → HTTP headers — THE one mapping shared by
    call_api (actions/world.py) and MCP server auth (infra/mcp.py), so a
    stored credential behaves identically wherever it's used. Raises
    ValueError for unknown types; callers wrap in their own error kind."""
    kind = auth.get("type", "bearer")
    if kind == "bearer":
        return {"Authorization": f"Bearer {auth.get('token', '')}"}
    if kind == "basic":
        import base64
        cred = f"{auth.get('username', '')}:{auth.get('password', '')}"
        return {"Authorization":
                "Basic " + base64.b64encode(cred.encode()).decode()}
    if kind == "header":
        return {auth.get("name", "X-Api-Key"): auth.get("value", "")}
    raise ValueError(f"unknown auth type {kind!r}")


class _VerifyingRedirectHandler(urllib.request.HTTPRedirectHandler):
    """Re-run the URL guard on every redirect hop — a public URL 302'ing to
    a loopback/metadata address must not slip past the initial check."""

    def __init__(self, verify: Callable[[str], None]):
        self._verify = verify

    def redirect_request(self, req, fp, code, msg, headers, newurl):
        self._verify(newurl)
        return super().redirect_request(req, fp, code, msg, headers, newurl)


def urllib_http(url: str, method: str = "GET",
                headers: Optional[Mapping[str, str]] = None,
                body: Optional[bytes] = None,
                timeout_s: float = DEFAULT_TIMEOUT_S,
                verify_url: Optional[Callable[[str], None]] = None) -> HttpResponse:
    """Default transport. ``verify_url`` (e.g. check_ssrf) is applied to
    the INITIAL url and to every redirect target. Residual risk: DNS
    rebinding between the check's resolution and urlopen's — acceptable for
    the reference-parity 'optional SSRF check' posture (web.ex:12-36)."""
    if verify_url is not None:
        verify_url(url)
    req = urllib.request.Request(url, data=body, method=method.upper())
    for k, v in (headers or {}).items():
        req.add_header(k, v)
    if "User-Agent" not in req.headers:
        req.add_header("User-Agent", "quoracle-tpu/0.1")
    opener = (urllib.request.build_opener(_VerifyingRedirectHandler(verify_url))
              if verify_url else urllib.request.build_opener())
    try:
        with opener.open(req, timeout=timeout_s) as resp:
            data = resp.read(MAX_RESPONSE_BYTES + 1)
            return HttpResponse(
                status=resp.status,
                headers={k.lower(): v for k, v in resp.headers.items()},
                body=data[:MAX_RESPONSE_BYTES],
                url=resp.url)
    except urllib.error.HTTPError as e:
        return HttpResponse(
            status=e.code,
            headers={k.lower(): v for k, v in (e.headers or {}).items()},
            body=e.read()[:MAX_RESPONSE_BYTES] if e.fp else b"",
            url=url)


class FakeHttp:
    """Test transport: route table of url-prefix → response or callable.
    Records every request (the reference's req_cassette/plug-stub role)."""

    def __init__(self, routes: Optional[dict] = None):
        self.routes = dict(routes or {})
        self.requests: list[dict] = []

    def add(self, prefix: str, response) -> None:
        self.routes[prefix] = response

    def __call__(self, url: str, method: str = "GET", headers=None,
                 body: Optional[bytes] = None,
                 timeout_s: float = DEFAULT_TIMEOUT_S) -> HttpResponse:
        self.requests.append({"url": url, "method": method,
                              "headers": dict(headers or {}), "body": body})
        for prefix, resp in self.routes.items():
            if url.startswith(prefix):
                if callable(resp):
                    resp = resp(url, method, headers, body)
                if isinstance(resp, HttpResponse):
                    return resp
                if isinstance(resp, tuple):
                    status, ctype, payload = resp
                    if isinstance(payload, str):
                        payload = payload.encode()
                    return HttpResponse(status=status,
                                        headers={"content-type": ctype},
                                        body=payload, url=url)
        return HttpResponse(status=404, headers={}, body=b"not found",
                            url=url)
