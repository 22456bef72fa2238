"""The network front door: an asyncio HTTP/JSON edge over the serving
stack (DESIGN.md §8; the port's counterpart of ``repro.serve.edge``).

Everything below :class:`~repro_torch.serve.client.AsyncANNSClient` is an
in-process API; real deployments take queries off a SOCKET.  This module
is that last hop, stdlib-only (``asyncio.start_server`` + minimal
HTTP/1.1 parsing — no web framework in the image, none needed):

* **routes** — ``POST /v1/search`` (JSON body: ``query`` plus optional
  ``k``/``top_n``/``deadline_s``/``tag``), ``GET /v1/stats`` (edge +
  client + backend counters), ``GET /healthz`` (serving/draining).
  Keep-alive HTTP/1.1: one connection serves many requests.
* **tenant auth** — when :class:`EdgeConfig.tenants` is non-empty every
  search must carry a known ``x-api-key`` header; the matching tenant's
  name is stamped on the :class:`~repro_torch.serve.client.SearchRequest`
  (``tenant=``) and rides to the response.  The backend is wrapped in a
  :class:`~repro_torch.serve.tenants.TenantManager`: it stamps each
  tenant's base predicate server-side (a client can narrow but never
  widen its namespace), keeps per-tenant books, and enforces the
  per-tenant :class:`TokenBucket` quota at submit —
  :class:`~repro_torch.serve.tenants.QuotaExceeded` maps to ``429`` with
  ``Retry-After``.  No tenants configured = an open edge.
* **filtered + adaptive search** — the search body optionally carries a
  ``filter`` predicate (DESIGN.md §11 wire grammar:
  ``{"eq": [col, v]}`` / ``{"in": …}`` / ``{"range": …}`` /
  ``{"and": […]}``) applied at candidate collection, and
  ``"adaptive": true`` opts into deadline-adaptive accuracy.
* **coalescing** — identical in-flight queries (same query bytes + plan
  knobs, :func:`~repro_torch.serve.client.coalesce_key`) share ONE backend
  submit via the client's :class:`~repro_torch.serve.client.RequestCoalescer`;
  a duplicate burst of N HTTP requests costs one scan.
* **structured errors** — every failure is
  ``{"error": {"code", "message"}}``: ``401 unauthorized``,
  ``429 rate_limited``, ``400 bad_request``, ``404 not_found``,
  ``413 body_too_large``, ``503 overloaded`` (edge admission guard) /
  ``503 draining``, ``504 deadline_exceeded``, ``500 internal``.
* **graceful drain** — ``aclose()`` stops accepting, lets every in-flight
  request finish (responses still flow on their keep-alive conns), closes
  idle connections, settles the client, then — only when the edge OWNS
  the backend (``own_backend=True``) — stops the router off-loop.  Zero
  futures leak at either level (tests/test_torch_edge.py).

:class:`HttpConn` is the matching minimal keep-alive client used by the
tests and by ``chip_smoke.py``; production callers can use anything that
speaks HTTP.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import time
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.filters import predicate_from_json
from repro_torch.core.futures import DeadlineExceeded
from repro_torch.serve.client import (AsyncANNSClient, RequestCoalescer,
                                      SearchRequest)
# TenantConfig/TokenBucket live in serve/tenants.py (quotas are
# submit-level admission, not an edge-local check); re-exported here
from repro_torch.serve.tenants import (QuotaExceeded, TenantConfig,
                                       TenantManager, TokenBucket)

__all__ = ["TenantConfig", "EdgeConfig", "TokenBucket", "AnnsEdge",
           "HttpConn"]

_MAX_HEADER_BYTES = 16 * 1024
_MAX_HEADERS = 64


@dataclasses.dataclass
class EdgeConfig:
    host: str = "127.0.0.1"
    port: int = 0                         # 0 = ephemeral (tests)
    tenants: Sequence[TenantConfig] = ()
    max_inflight: int = 256               # client-side admission semaphore
    max_pending: int = 1024               # edge guard: live HTTP requests
    default_deadline_s: Optional[float] = None
    coalesce: bool = True
    max_body_bytes: int = 1 << 20


class _HttpError(Exception):
    def __init__(self, status: int, code: str, message: str,
                 headers: Optional[Dict[str, str]] = None):
        super().__init__(message)
        self.status, self.code, self.message = status, code, message
        self.headers = headers or {}


_STATUS_TEXT = {200: "OK", 400: "Bad Request", 401: "Unauthorized",
                404: "Not Found", 405: "Method Not Allowed",
                413: "Payload Too Large", 429: "Too Many Requests",
                500: "Internal Server Error", 503: "Service Unavailable",
                504: "Gateway Timeout"}


class AnnsEdge:
    """The HTTP front door over any Backend (normally a
    :class:`~repro_torch.serve.router.ReplicaRouter`).

    ``own_backend=True`` makes ``aclose()`` also stop the backend (the
    standalone-server shape); a shared backend is left running.
    ``clock`` feeds the tenant rate limiters (injectable for tests)."""

    def __init__(self, backend, config: Optional[EdgeConfig] = None, *,
                 own_backend: bool = False,
                 clock: Callable[[], float] = time.monotonic, **overrides):
        self.backend = backend
        self.cfg = config or EdgeConfig(**overrides)
        self.own_backend = own_backend
        coalescer = None
        if self.cfg.coalesce:
            # the stack's accuracy knobs are part of result identity, so
            # they fold into every coalescing key — and so is the index's
            # segment-list epoch (DESIGN.md §10): backends expose
            # ``.epoch`` and a mutation bumps it, keeping waiters from
            # attaching to a leader dispatched against pre-mutation state
            epoch_source = ((lambda: backend.epoch)
                            if hasattr(backend, "epoch") else None)
            coalescer = RequestCoalescer(
                fused=bool(getattr(backend, "fused", False)),
                lut_int8=bool(getattr(backend, "lut_int8", False)),
                epoch_source=epoch_source)
        # tenants configured -> wrap the backend in a TenantManager: the
        # quota gate, base-predicate stamping (the request can only ever
        # narrow its tenant's namespace — isolation is server-side, a
        # client-supplied filter cannot widen it), and per-tenant query
        # books all live at the submit layer, not in the HTTP handler
        self.manager: Optional[TenantManager] = None
        if self.cfg.tenants:
            self.manager = TenantManager(backend, self.cfg.tenants,
                                         clock=clock)
        self.client = AsyncANNSClient(self.manager or backend,
                                      max_inflight=self.cfg.max_inflight,
                                      coalescer=coalescer)
        self._keys = {t.api_key: t for t in self.cfg.tenants}
        self.tenant_stats: Dict[str, Dict[str, int]] = {
            t.name: {"requests": 0, "ok": 0, "rate_limited": 0,
                     "errors": 0} for t in self.cfg.tenants}
        self.stats: Dict[str, int] = {
            "conns": 0, "requests": 0, "ok": 0, "auth_failures": 0,
            "rate_limited": 0, "bad_requests": 0, "not_found": 0,
            "deadline_expired": 0, "overloaded": 0, "draining_rejects": 0,
            "internal_errors": 0}
        self._server: Optional[asyncio.AbstractServer] = None
        self._writers: set = set()         # open connections (drain close)
        self._live_requests = 0            # requests between parse+respond
        self._idle_evt = asyncio.Event()
        self._idle_evt.set()
        self._draining = False
        self.port: Optional[int] = None

    # ------------------------------------------------------------ lifecycle
    async def start(self) -> "AnnsEdge":
        self._server = await asyncio.start_server(
            self._handle_conn, self.cfg.host, self.cfg.port)
        self.port = self._server.sockets[0].getsockname()[1]
        return self

    async def aclose(self) -> None:
        """Graceful drain, strictly ordered: (1) stop accepting, (2) let
        every in-flight request finish — their responses still flow, (3)
        close the now-idle connections, (4) settle the client (zero
        pending backend futures), (5) stop an OWNED backend off-loop."""
        self._draining = True
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None
        await self._idle_evt.wait()            # (2) in-flight requests
        for w in list(self._writers):          # (3) idle keep-alive conns
            w.close()
        self._writers.clear()
        await self.client.aclose()             # (4)
        if self.own_backend:                   # (5) router.stop() blocks on
            loop = asyncio.get_running_loop()  # pump joins: off-loop
            await loop.run_in_executor(None, self.backend.stop)

    async def __aenter__(self) -> "AnnsEdge":
        return await self.start()

    async def __aexit__(self, *exc) -> None:
        await self.aclose()

    # ----------------------------------------------------------- connection
    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        self.stats["conns"] += 1
        self._writers.add(writer)
        try:
            while not self._draining:
                try:
                    parsed = await self._read_request(reader)
                except (asyncio.IncompleteReadError, ConnectionError):
                    return                     # peer closed between requests
                except _HttpError as exc:      # unparseable request: answer
                    self.stats["bad_requests"] += 1   # and drop the conn
                    try:
                        await self._write_response(
                            writer, exc.status,
                            {"error": {"code": exc.code,
                                       "message": exc.message}},
                            exc.headers, keep=False)
                    except ConnectionError:
                        pass
                    return
                if parsed is None:
                    return                     # clean EOF
                method, path, headers, body = parsed
                # the in-flight window covers routing AND the response
                # write: aclose() must not close this socket until the
                # bytes are out
                self._live_requests += 1
                self._idle_evt.clear()
                try:
                    try:
                        status, payload, extra = await self._route(
                            method, path, headers, body)
                    except _HttpError as exc:
                        status = exc.status
                        payload = {"error": {"code": exc.code,
                                             "message": exc.message}}
                        extra = exc.headers
                    except Exception as exc:   # noqa: BLE001 — must answer
                        self.stats["internal_errors"] += 1
                        status = 500
                        payload = {"error": {"code": "internal",
                                             "message": repr(exc)}}
                        extra = {}
                    keep = (headers.get("connection", "keep-alive").lower()
                            != "close") and not self._draining
                    try:
                        await self._write_response(writer, status, payload,
                                                   extra, keep=keep)
                    except ConnectionError:
                        return
                finally:
                    self._live_requests -= 1
                    if self._live_requests == 0:
                        self._idle_evt.set()
                if not keep:
                    return
        finally:
            self._writers.discard(writer)
            writer.close()

    async def _read_request(self, reader: asyncio.StreamReader):
        """One HTTP/1.1 request off the stream; None on clean EOF."""
        line = await reader.readline()
        if not line:
            return None
        try:
            method, path, _version = line.decode("latin1").split(None, 2)
        except ValueError:
            raise _HttpError(400, "bad_request",
                             "malformed request line") from None
        headers: Dict[str, str] = {}
        total = len(line)
        for _ in range(_MAX_HEADERS):
            h = await reader.readline()
            total += len(h)
            if total > _MAX_HEADER_BYTES:
                raise _HttpError(400, "bad_request", "headers too large")
            if h in (b"\r\n", b"\n", b""):
                break
            name, _, value = h.decode("latin1").partition(":")
            headers[name.strip().lower()] = value.strip()
        else:
            raise _HttpError(400, "bad_request", "too many headers")
        body = b""
        n = int(headers.get("content-length", 0) or 0)
        if n > self.cfg.max_body_bytes:
            raise _HttpError(413, "body_too_large",
                             f"body of {n} bytes exceeds "
                             f"{self.cfg.max_body_bytes}")
        if n:
            body = await reader.readexactly(n)
        return method.upper(), path, headers, body

    async def _write_response(self, writer: asyncio.StreamWriter,
                              status: int, payload: Dict,
                              extra: Dict[str, str], *, keep: bool) -> None:
        data = json.dumps(payload).encode()
        head = [f"HTTP/1.1 {status} {_STATUS_TEXT.get(status, 'Status')}",
                "Content-Type: application/json",
                f"Content-Length: {len(data)}",
                f"Connection: {'keep-alive' if keep else 'close'}"]
        head += [f"{k}: {v}" for k, v in extra.items()]
        writer.write(("\r\n".join(head) + "\r\n\r\n").encode() + data)
        await writer.drain()

    # -------------------------------------------------------------- routing
    async def _route(self, method: str, path: str, headers: Dict[str, str],
                     body: bytes) -> Tuple[int, Dict, Dict[str, str]]:
        if path == "/healthz":
            return 200, {"status": "draining" if self._draining
                         else "serving"}, {}
        if path == "/v1/stats" and method == "GET":
            return 200, self._stats_payload(), {}
        if path == "/v1/search":
            if method != "POST":
                raise _HttpError(405, "method_not_allowed",
                                 "POST /v1/search")
            return await self._search(headers, body)
        self.stats["not_found"] += 1
        raise _HttpError(404, "not_found", f"no route for {path}")

    def _authenticate(self, headers: Dict[str, str]
                      ) -> Optional[TenantConfig]:
        if not self._keys:
            return None                       # open edge
        key = headers.get("x-api-key")
        tenant = self._keys.get(key) if key else None
        if tenant is None:
            self.stats["auth_failures"] += 1
            raise _HttpError(401, "unauthorized",
                             "missing or unknown x-api-key")
        return tenant

    async def _search(self, headers: Dict[str, str], body: bytes
                      ) -> Tuple[int, Dict, Dict[str, str]]:
        self.stats["requests"] += 1
        if self._draining:
            self.stats["draining_rejects"] += 1
            raise _HttpError(503, "draining", "edge is draining")
        tenant = self._authenticate(headers)
        tstats = None
        if tenant is not None:
            tstats = self.tenant_stats[tenant.name]
            tstats["requests"] += 1
        if self._live_requests > self.cfg.max_pending:
            self.stats["overloaded"] += 1
            raise _HttpError(503, "overloaded",
                             f"{self.cfg.max_pending} requests in flight")
        req = self._parse_search(body,
                                 None if tenant is None else tenant.name)
        try:
            resp = await self.client.search(req)
        except QuotaExceeded as exc:
            # the TenantManager's admission gate (serve/tenants.py): the
            # backend never saw the request
            self.stats["rate_limited"] += 1
            if tstats is not None:
                tstats["rate_limited"] += 1
            raise _HttpError(
                429, "rate_limited", str(exc),
                {"Retry-After": f"{exc.retry_after:.3f}"}) from None
        except DeadlineExceeded as exc:
            self.stats["deadline_expired"] += 1
            if tstats is not None:
                tstats["errors"] += 1
            raise _HttpError(504, "deadline_exceeded", str(exc)) from None
        except Exception:
            if tstats is not None:
                tstats["errors"] += 1
            raise
        self.stats["ok"] += 1
        if tstats is not None:
            tstats["ok"] += 1
        return 200, {"ids": np.asarray(resp.ids).tolist(),
                     "dists": np.asarray(resp.dists, np.float64).tolist(),
                     "latency_s": resp.latency_s,
                     "batch_size": resp.batch_size,
                     "tenant": resp.tenant,
                     "tag": resp.tag}, {}

    def _parse_search(self, body: bytes, tenant: Optional[str]
                      ) -> SearchRequest:
        self_cfg = self.cfg
        try:
            doc = json.loads(body.decode())
        except (ValueError, UnicodeDecodeError) as exc:
            self.stats["bad_requests"] += 1
            raise _HttpError(400, "bad_request",
                             f"invalid JSON body: {exc}") from None
        if not isinstance(doc, dict) or "query" not in doc:
            self.stats["bad_requests"] += 1
            raise _HttpError(400, "bad_request",
                             'body must be a JSON object with "query"')
        try:
            query = np.asarray(doc["query"], np.float32)
            if query.ndim != 1 or query.size == 0:
                raise ValueError(f"query must be a non-empty 1-D vector, "
                                 f"got shape {query.shape}")
            k = doc.get("k")
            top_n = doc.get("top_n")
            deadline_s = doc.get("deadline_s",
                                 self_cfg.default_deadline_s)
            if k is not None:
                k = int(k)
            if top_n is not None:
                top_n = int(top_n)
            if deadline_s is not None:
                deadline_s = float(deadline_s)
            # metadata predicate (DESIGN.md §11 wire grammar) + the
            # deadline-adaptive accuracy opt-in; a malformed predicate is
            # a 400 like any other bad knob
            filt = predicate_from_json(doc.get("filter"))
            adaptive = bool(doc.get("adaptive", False))
        except (TypeError, ValueError) as exc:
            self.stats["bad_requests"] += 1
            raise _HttpError(400, "bad_request", str(exc)) from None
        return SearchRequest(query=query, k=k, top_n=top_n,
                             deadline_s=deadline_s, tag=doc.get("tag"),
                             tenant=tenant, filter=filt, adaptive=adaptive)

    def _stats_payload(self) -> Dict[str, object]:
        out: Dict[str, object] = {"edge": dict(self.stats),
                                  "tenants": {n: dict(s) for n, s in
                                              self.tenant_stats.items()},
                                  "client": dict(self.client.stats)}
        co = self.client.coalescer
        if co is not None:
            out["coalescer"] = {**co.stats, "live": co.live()}
        if self.manager is not None:
            # the submit-layer books (quota rejects, per-tenant QueryStats
            # + latency percentiles) — distinct from the HTTP counters in
            # "tenants" above
            out["tenant_service"] = self.manager.tenant_rollup()
        sig = getattr(self.backend, "scaling_signals", None)
        if sig is not None:
            out["backend"] = sig()
        else:
            out["backend"] = {"live_load": self.backend.live_load()}
        return out


# ---------------------------------------------------------------------------
# Minimal keep-alive HTTP client (tests / smoke run)
# ---------------------------------------------------------------------------

class HttpConn:
    """One keep-alive HTTP/1.1 connection speaking JSON — just enough
    client to exercise the edge through a real socket (the tests' and
    the smoke run's counterpart to :class:`AnnsEdge`)."""

    def __init__(self, reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter):
        self.reader, self.writer = reader, writer

    @classmethod
    async def open(cls, host: str, port: int) -> "HttpConn":
        reader, writer = await asyncio.open_connection(host, port)
        return cls(reader, writer)

    async def request(self, method: str, path: str,
                      body: Optional[Dict] = None,
                      headers: Optional[Dict[str, str]] = None
                      ) -> Tuple[int, Any]:
        data = b"" if body is None else json.dumps(body).encode()
        head = [f"{method} {path} HTTP/1.1", "Host: edge",
                f"Content-Length: {len(data)}",
                "Content-Type: application/json"]
        head += [f"{k}: {v}" for k, v in (headers or {}).items()]
        self.writer.write(("\r\n".join(head) + "\r\n\r\n").encode() + data)
        await self.writer.drain()
        status_line = await self.reader.readline()
        if not status_line:
            raise ConnectionError("edge closed the connection")
        status = int(status_line.split()[1])
        n = 0
        while True:
            h = await self.reader.readline()
            if h in (b"\r\n", b"\n", b""):
                break
            name, _, value = h.decode("latin1").partition(":")
            if name.strip().lower() == "content-length":
                n = int(value)
        payload = json.loads((await self.reader.readexactly(n)).decode()) \
            if n else None
        return status, payload

    async def aclose(self) -> None:
        self.writer.close()
        try:
            await self.writer.wait_closed()
        except (ConnectionError, OSError):
            pass
