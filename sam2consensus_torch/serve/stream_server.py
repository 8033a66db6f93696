"""Network front door for streaming sessions: a fault-tolerant HTTP/1.1

Copy of ``sam2consensus_tpu/serve/stream_server.py`` (pinned by
``tests/test_torch_copies.py``) over the port's
:class:`~.session.SessionManager`.  Each request runs on its own
handler thread, so a wave's absorb (and its kernel launches) runs on
that thread, serialised by the manager's backend lock.

ingest endpoint.

Rides the TelemetryServer pattern (observability/telemetry.py): stdlib
``ThreadingHTTPServer`` bound to 127.0.0.1 only (``--ingest-port``; 0 =
ephemeral, ``.port`` holds the real one), daemon handler threads, a
handler body that catches everything — one broken request can never
kill the server.  What it adds over the scrape endpoint is everything a
front door facing real (slow, buggy, malicious) clients needs:

* **POST bodies**, both ``Content-Length`` and ``Transfer-Encoding:
  chunked`` (decoded manually — live basecallers stream waves without
  knowing their size up front);
* **bounded requests** — a declared or actual body over
  ``max_body`` answers 413 before buffering the excess;
* **slow-client timeouts** — a per-request socket deadline
  (``timeout``): a client that stops mid-body answers 408 and frees
  the handler thread instead of wedging it forever;
* **typed failures** — every rejection is a JSON body with a
  machine-readable ``reason`` and the right status: 400 malformed
  framing, 404 unknown session, 405 wrong method, 408 slow client,
  409 closed session / lost lease, 413 oversized, 422 DATA-class
  poison wave (quarantined, never retried), 429 + ``Retry-After``
  admission backpressure, 503 transient absorb failure.  Rejecting
  with a reason IS the backpressure signal — the server never wedges;
* **keep-alive framing safety** — an error answered before the
  request body was fully consumed closes the connection instead of
  letting the unread bytes desync the next request on the socket;
* the ``ingest_conn`` fault site fires per request (the chaos
  harness's handle on torn connections).

Routes::

    POST /session/open          body = SAM header  -> {sid}
    POST /session/<sid>/wave    body = read lines  -> wave ACK
    POST /session/<sid>/revote                     -> {digest, stable}
    POST /session/<sid>/close                      -> final outputs
    GET  /session/<sid>                            -> status JSON
    GET  /sessions                                 -> health summary

Headers: ``X-Tenant`` labels the session at open; ``X-Wave-Sha256``
lets a client declare the wave body's hash — a mismatch is rejected
422 (the torn-upload gate) instead of being absorbed.
"""

from __future__ import annotations

import json
import logging
import socket
import threading
from typing import Optional

from .session import SessionError, SessionManager

logger = logging.getLogger("sam2consensus_torch.serve.stream_server")

#: request body bound (bytes); --ingest-max-body overrides
DEFAULT_MAX_BODY = 64 * 1024 * 1024
#: per-request socket deadline (seconds); --ingest-timeout overrides
DEFAULT_TIMEOUT_S = 10.0
#: per-chunk-size-line bound: a chunked framing line longer than this
#: is not a hex size, it is garbage (or an attack)
_MAX_CHUNK_LINE = 64


class RequestError(Exception):
    """Typed framing/transport failure, mapped straight to a status."""

    def __init__(self, status: int, reason: str, detail: str = ""):
        super().__init__(detail or reason)
        self.status = int(status)
        self.reason = reason


def _read_exact(rfile, n: int) -> bytes:
    """Read exactly ``n`` bytes or raise the truncated-body error —
    a short read is a client that died mid-wave, not a wave."""
    out = b""
    while len(out) < n:
        chunk = rfile.read(n - len(out))
        if not chunk:
            raise RequestError(400, "truncated_body",
                               f"body ended after {len(out)} of {n} "
                               f"bytes")
        out += chunk
    return out


def read_chunked(rfile, max_body: int) -> bytes:
    """Manual ``Transfer-Encoding: chunked`` decode, size-bounded.

    Malformed framing (non-hex size line, missing CRLF, truncation) is
    a 400; exceeding ``max_body`` is a 413 raised BEFORE buffering the
    offending chunk."""
    body = b""
    while True:
        line = rfile.readline(_MAX_CHUNK_LINE + 2)
        if not line.endswith(b"\n"):
            raise RequestError(400, "bad_chunk_size",
                               "chunk-size line unterminated or over "
                               f"{_MAX_CHUNK_LINE} bytes")
        token = line.strip().split(b";")[0]     # ignore extensions
        try:
            size = int(token, 16)
        except ValueError:
            raise RequestError(
                400, "bad_chunk_size",
                f"chunk-size line {token[:32]!r} is not hex") from None
        if size < 0:
            raise RequestError(400, "bad_chunk_size", "negative size")
        if size == 0:
            # trailer section: consume until the blank line
            while True:
                t = rfile.readline(_MAX_CHUNK_LINE + 2)
                if t in (b"\r\n", b"\n", b""):
                    break
            return body
        if len(body) + size > max_body:
            raise RequestError(413, "body_too_large",
                               f"chunked body exceeds {max_body} bytes")
        body += _read_exact(rfile, size)
        crlf = _read_exact(rfile, 2)
        if crlf not in (b"\r\n",):
            raise RequestError(400, "bad_chunk_framing",
                               "chunk data not CRLF-terminated")


class IngestServer:
    """The streaming-session front door (see the module docstring)."""

    def __init__(self, manager: SessionManager, port: int = 0,
                 max_body: int = DEFAULT_MAX_BODY,
                 timeout: float = DEFAULT_TIMEOUT_S):
        from http.server import (BaseHTTPRequestHandler,
                                 ThreadingHTTPServer)

        outer = self
        self.manager = manager
        self.registry = manager.registry
        self.max_body = int(max_body)
        self.timeout = float(timeout)

        class _Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            # -- plumbing ---------------------------------------------
            def _reply(self, status: int, payload: dict,
                       retry_after: Optional[float] = None) -> None:
                body = (json.dumps(payload, default=str) + "\n") \
                    .encode("utf-8")
                self.send_response(status)
                self.send_header("Content-Type",
                                 "application/json; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                if retry_after is not None:
                    self.send_header("Retry-After",
                                     str(max(1, int(retry_after))))
                self.end_headers()
                self.wfile.write(body)

            def _error(self, status: int, reason: str, detail: str = "",
                       retry_after: Optional[float] = None) -> None:
                # an error answered BEFORE the request body was fully
                # consumed leaves its unread bytes on the socket; on a
                # keep-alive connection the next "request" would be
                # parsed out of those leftovers (a 400 cascade), so
                # the connection must close instead of desyncing
                if not getattr(self, "_body_done", True):
                    self.close_connection = True
                outer.registry.add("ingest/rejected", 1)
                outer.registry.add(f"ingest/rejected/{reason}", 1)
                self._reply(status, {"error": reason,
                                     "detail": detail or reason},
                            retry_after=retry_after)

            def _read_body(self) -> bytes:
                te = (self.headers.get("Transfer-Encoding") or "") \
                    .lower()
                if "chunked" in te:
                    body = read_chunked(self.rfile, outer.max_body)
                    self._body_done = True
                    return body
                cl = self.headers.get("Content-Length")
                if cl is None:
                    raise RequestError(
                        400, "length_required",
                        "POST needs Content-Length or chunked "
                        "transfer-encoding")
                try:
                    n = int(cl)
                except ValueError:
                    raise RequestError(
                        400, "bad_content_length",
                        f"Content-Length {cl!r} is not an "
                        f"integer") from None
                if n < 0:
                    raise RequestError(400, "bad_content_length",
                                       "negative Content-Length")
                if n > outer.max_body:
                    raise RequestError(
                        413, "body_too_large",
                        f"declared {n} bytes exceeds the "
                        f"{outer.max_body}-byte wave bound")
                body = _read_exact(self.rfile, n)
                self._body_done = True
                return body

            def _drain_body(self) -> None:
                """Consume a (possibly present) body on verbs that
                take none, so a keep-alive connection stays framed."""
                if "Content-Length" in self.headers \
                        or "Transfer-Encoding" in self.headers:
                    self._read_body()
                else:
                    self._body_done = True

            # -- routes -----------------------------------------------
            def do_POST(self):          # noqa: N802 (stdlib name)
                self._body_done = False     # set by a complete read
                try:
                    self.connection.settimeout(outer.timeout)
                    outer.registry.add("ingest/requests", 1)
                    outer.manager.runner._fault_check("ingest_conn")
                    parts = [p for p in
                             self.path.split("?")[0].split("/") if p]
                    if not parts or parts[0] != "session":
                        self._error(404, "not_found",
                                    f"no such route {self.path!r}")
                        return
                    if parts[1:] == ["open"]:
                        body = self._read_body()
                        outer.registry.add("ingest/bytes", len(body))
                        res = outer.manager.open_session(
                            body.decode("utf-8", errors="strict"),
                            tenant=self.headers.get("X-Tenant", ""))
                        self._reply(200, res)
                        return
                    if len(parts) != 3:
                        self._error(404, "not_found",
                                    f"no such route {self.path!r}")
                        return
                    sid, verb = parts[1], parts[2]
                    if verb == "wave":
                        body = self._read_body()
                        outer.registry.add("ingest/bytes", len(body))
                        res = outer.manager.receive_wave(
                            sid, body,
                            declared_sha=self.headers.get(
                                "X-Wave-Sha256"))
                        self._reply(
                            202 if res.get("status") == "pending"
                            else 200, res)
                    elif verb == "revote":
                        self._drain_body()
                        self._reply(200, outer.manager.revote(sid))
                    elif verb == "close":
                        self._drain_body()
                        self._reply(200,
                                    outer.manager.close_session(sid))
                    else:
                        self._error(404, "not_found",
                                    f"no session verb {verb!r}")
                except SessionError as exc:
                    self._safe_error(exc.status, exc.reason, str(exc),
                                     retry_after=exc.retry_after)
                except RequestError as exc:
                    self._safe_error(exc.status, exc.reason, str(exc))
                except (socket.timeout, TimeoutError):
                    outer.registry.add("ingest/slow_clients", 1)
                    self._safe_error(408, "slow_client",
                                     f"no bytes within "
                                     f"{outer.timeout:g}s")
                except UnicodeDecodeError as exc:
                    self._safe_error(422, "bad_encoding", str(exc))
                except Exception as exc:   # never kill the server
                    logger.warning("ingest request failed (%s: %s)",
                                   type(exc).__name__, exc)
                    self._safe_error(500, "internal",
                                     f"{type(exc).__name__}: {exc}")

            def do_GET(self):           # noqa: N802 (stdlib name)
                self._body_done = False
                try:
                    self.connection.settimeout(outer.timeout)
                    self._drain_body()  # a GET with a body stays framed
                    parts = [p for p in
                             self.path.split("?")[0].split("/") if p]
                    if parts == ["sessions"]:
                        self._reply(
                            200, outer.manager.health_summary())
                    elif len(parts) == 2 and parts[0] == "session":
                        self._reply(200,
                                    outer.manager.status(parts[1]))
                    else:
                        self._error(404, "not_found",
                                    f"no such route {self.path!r}")
                except SessionError as exc:
                    self._safe_error(exc.status, exc.reason, str(exc))
                except RequestError as exc:
                    self._safe_error(exc.status, exc.reason, str(exc))
                except Exception as exc:
                    self._safe_error(500, "internal",
                                     f"{type(exc).__name__}: {exc}")

            def _safe_error(self, status, reason, detail,
                            retry_after=None):
                """Answer an error on a socket that may already be
                dead — the client tearing its connection mid-reply
                must not take the handler (or server) down."""
                try:
                    self._error(status, reason, detail,
                                retry_after=retry_after)
                except Exception:
                    self.close_connection = True

            def do_PUT(self):           # noqa: N802
                self._body_done = False
                try:
                    self.connection.settimeout(outer.timeout)
                    self._drain_body()  # keep the connection framed
                except Exception:
                    pass                # _error closes it instead
                self._safe_error(405, "method_not_allowed",
                                 "use POST/GET")

            do_DELETE = do_PATCH = do_HEAD = do_PUT

            def log_message(self, *a):  # waves are not stderr news
                pass

        self._httpd = ThreadingHTTPServer(("127.0.0.1", port), _Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_port
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="s2c-ingest-http")
        self._thread.start()
        logger.info("streaming ingest endpoint on 127.0.0.1:%d",
                    self.port)

    def close(self) -> None:
        try:
            self._httpd.shutdown()
            self._httpd.server_close()
        except Exception:
            pass
