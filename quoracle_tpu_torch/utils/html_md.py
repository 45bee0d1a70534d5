"""HTML → Markdown conversion for fetched pages.

The reference converts with the htmd library (reference
lib/quoracle/actions/web.ex:12-36 — fetch → HTML-to-Markdown → truncate).
This is a stdlib html.parser implementation covering the structures agents
actually read: headings, paragraphs, lists, links, emphasis, code,
blockquotes, tables (flattened), with script/style/nav noise dropped.

The PyTorch port's copy of ``quoracle_tpu/utils/html_md.py``.
"""

from __future__ import annotations

import re
from html.parser import HTMLParser

_SKIP = {"script", "style", "noscript", "svg", "head", "iframe", "canvas"}
_BLOCK = {"p", "div", "section", "article", "li", "tr", "br", "table",
          "ul", "ol", "blockquote", "pre", "header", "footer", "nav",
          "h1", "h2", "h3", "h4", "h5", "h6"}


class _MdExtractor(HTMLParser):
    def __init__(self) -> None:
        super().__init__(convert_charrefs=True)
        self.out: list[str] = []
        self._skip_depth = 0
        self._href: str | None = None
        self._list_stack: list[str] = []
        self._in_pre = False

    # -- tag handling -------------------------------------------------

    def handle_starttag(self, tag, attrs):
        if tag in _SKIP:
            self._skip_depth += 1
            return
        if self._skip_depth:
            return
        a = dict(attrs)
        if tag in ("h1", "h2", "h3", "h4", "h5", "h6"):
            self.out.append("\n\n" + "#" * int(tag[1]) + " ")
        elif tag == "a":
            self._href = a.get("href")
            self.out.append("[")
        elif tag in ("b", "strong"):
            self.out.append("**")
        elif tag in ("i", "em"):
            self.out.append("*")
        elif tag == "code" and not self._in_pre:
            self.out.append("`")
        elif tag == "pre":
            self._in_pre = True
            self.out.append("\n\n```\n")
        elif tag in ("ul", "ol"):
            self._list_stack.append(tag)
        elif tag == "li":
            marker = ("- " if not self._list_stack
                      or self._list_stack[-1] == "ul" else "1. ")
            self.out.append("\n" + "  " * max(0, len(self._list_stack) - 1)
                            + marker)
        elif tag == "blockquote":
            self.out.append("\n\n> ")
        elif tag == "img":
            alt = a.get("alt") or "image"
            src = a.get("src", "")
            self.out.append(f"![{alt}]({src})")
        elif tag in ("td", "th"):
            self.out.append(" | ")
        elif tag in _BLOCK:
            self.out.append("\n\n")

    def handle_endtag(self, tag):
        if tag in _SKIP:
            self._skip_depth = max(0, self._skip_depth - 1)
            return
        if self._skip_depth:
            return
        if tag == "a":
            href = self._href or ""
            self._href = None
            self.out.append(f"]({href})" if href else "]")
        elif tag in ("b", "strong"):
            self.out.append("**")
        elif tag in ("i", "em"):
            self.out.append("*")
        elif tag == "code" and not self._in_pre:
            self.out.append("`")
        elif tag == "pre":
            self._in_pre = False
            self.out.append("\n```\n")
        elif tag in ("ul", "ol"):
            if self._list_stack:
                self._list_stack.pop()
            self.out.append("\n")
        elif tag in _BLOCK:
            self.out.append("\n")

    def handle_data(self, data):
        if self._skip_depth:
            return
        if self._in_pre:
            self.out.append(data)
        else:
            self.out.append(re.sub(r"\s+", " ", data))


def html_to_markdown(html: str) -> str:
    parser = _MdExtractor()
    try:
        parser.feed(html)
        parser.close()
    except Exception:
        pass  # best-effort on malformed HTML; keep what was extracted
    text = "".join(parser.out)
    text = re.sub(r"[ \t]+\n", "\n", text)
    text = re.sub(r"\n{3,}", "\n\n", text)
    return text.strip()
