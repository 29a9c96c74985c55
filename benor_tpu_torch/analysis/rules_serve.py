"""Serve-plane rule: no blocking calls on the event loop (port of
benor_tpu/analysis/rules_serve.py).

The request plane (serve/server.py) is one asyncio event loop
serving thousands of concurrent SSE streams; ONE blocking call inside
an ``async def`` handler stalls every client at once — the classic
async-server failure mode, and invisible to tests that drive a handful
of connections.  The device work lives on the batcher thread by design;
handler code must only await.

``serve-blocking-call`` flags, anywhere lexically inside an
``async def`` (nested sync helpers included — they run on the loop when
the handler calls them):

  * ``time.sleep(...)``            — the canonical loop-stall (spell it
                                     ``await asyncio.sleep(...)``)
  * ``<tensor>.item()`` / ``.cpu()`` / ``.tolist()`` and
    ``torch.cuda.synchronize()``   — device syncs: each blocks the loop
                                     on the card's whole queue (fetch on
                                     the batcher thread, publish the
                                     value)
  * raw socket/HTTP constructions  — ``socket.socket`` /
    ``socket.create_connection`` / ``urllib.request.urlopen`` /
    ``http.client.HTTPConnection`` and ``requests.*`` calls: kernel-
    blocking I/O with no awaitable handle (use asyncio streams)
  * ``subprocess.run`` / ``check_output`` / ``check_call`` / ``call``

The standard ``# benorlint: allow-serve-blocking-call`` pragma is the
escape hatch for a justified exception (none shipped today).
"""

from __future__ import annotations

import ast
from typing import List

from .core import Finding, Project, dotted_name, rule
from .visitors import _canonical

#: Canonical dotted names whose CALL blocks the loop.
_BLOCKING_CALLS = frozenset({
    "time.sleep",
    "socket.socket",
    "socket.create_connection",
    "urllib.request.urlopen",
    "http.client.HTTPConnection",
    "http.client.HTTPSConnection",
    "subprocess.run",
    "subprocess.call",
    "subprocess.check_call",
    "subprocess.check_output",
    "torch.cuda.synchronize",
})

#: Tensor methods that copy a device value to the host: a sync each.
_SYNC_METHODS = ("item", "cpu", "tolist")

#: Any call through the `requests` package (fetch-style HTTP client —
#: the reference's fire-and-forget idiom, and 100% blocking).
_BLOCKING_ROOTS = ("requests",)

_HINT = ("handlers must only await: move device/file/socket work to the "
         "batcher thread (serve/batcher.py) or an asyncio primitive "
         "(asyncio.sleep, asyncio.open_connection, loop.run_in_executor)")


def _blocking_name(project: Project, rel: str, node: ast.Call):
    """Canonical blocked name of a call node, or None."""
    name = dotted_name(node.func)
    if not name:
        return None
    idx = project.index
    canon = _canonical(idx.module_of[rel], idx, name)
    if canon in _BLOCKING_CALLS:
        return canon
    if canon.split(".")[0] in _BLOCKING_ROOTS:
        return canon
    return None


@rule("serve-blocking-call", "serve",
      "blocking host-sync / sleep / raw-socket call inside async "
      "handler code (stalls every client on the event loop)")
def check_serve_blocking(project: Project) -> List[Finding]:
    findings: List[Finding] = []
    for rel, src in project.sources.items():
        for fn in src.nodes:
            if not isinstance(fn, ast.AsyncFunctionDef):
                continue
            for node in ast.walk(fn):
                if node is not fn and isinstance(node,
                                                 ast.AsyncFunctionDef):
                    continue  # nested async defs get their own walk
                if not isinstance(node, ast.Call):
                    continue
                canon = _blocking_name(project, rel, node)
                if canon is not None:
                    findings.append(Finding(
                        "serve-blocking-call", rel, node.lineno,
                        node.col_offset,
                        f"{canon}(...) inside async {fn.name!r} blocks "
                        f"the event loop: every concurrent SSE client "
                        f"stalls behind this call",
                        hint=_HINT))
                    continue
                f = node.func
                if isinstance(f, ast.Attribute) and \
                        f.attr in _SYNC_METHODS and not node.args and \
                        not node.keywords:
                    findings.append(Finding(
                        "serve-blocking-call", rel, node.lineno,
                        node.col_offset,
                        f".{f.attr}() inside async {fn.name!r} is a host "
                        f"sync: the event loop blocks on device "
                        f"completion while every other client waits",
                        hint=_HINT))
    return findings
