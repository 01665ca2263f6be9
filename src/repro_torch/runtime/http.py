"""SPARQL-Protocol-style HTTP front end over the admission queue.

Stdlib only (``http.server.ThreadingHTTPServer``): the constraint of this
repo is zero new dependencies, and a thread-per-connection server is
exactly right here — each handler thread blocks on its
:class:`~repro_torch.runtime.admission.Ticket` while the admission dispatcher
coalesces all concurrently waiting requests into ONE engine batch. The
concurrency win comes from the admission layer, not the HTTP layer.

Routes (subset of the W3C SPARQL 1.1 Protocol):

- ``GET /sparql?query=...`` — also ``timeout`` (seconds) and ``user``
  (integer id, routes ``mode="round"`` scheduling) parameters.
- ``POST /sparql`` with ``application/sparql-query`` (raw query body) or
  ``application/x-www-form-urlencoded`` (``query=`` field).
- ``POST /sparql`` with ``application/sparql-update`` (raw ``INSERT DATA``
  / ``DELETE DATA`` / ``DELETE WHERE`` body) or a form ``update=`` field —
  the write rides the same admission queue, serializing against the
  micro-batch window it shares (reads first, then the write commits), and
  returns a JSON ack (``inserted``/``deleted``/``new_terms``/...).
- ``POST /update``, the protocol's separate update endpoint: the same
  write, as a raw ``application/sparql-update`` body or a form
  ``update=`` field (a query there is a 400).
- ``GET /stats`` — admission + engine counters as JSON.
- ``GET /healthz`` — liveness probe.

Results are W3C *SPARQL 1.1 Query Results JSON*: SELECT returns
``{"head": {"vars": [...]}, "results": {"bindings": [...]}}`` with unbound
variables omitted from their binding object (per spec); ASK returns
``{"head": {}, "boolean": ...}``. Term typing: the dictionary keeps
predicate and entity ids in disjoint spaces but records no IRI/literal
distinction, so predicate-space terms serialize as ``"type": "uri"`` and
entity-space terms as ``"type": "literal"`` — lossless for round-tripping
through this repo's own parser, approximate against full RDF.

Status mapping: 400 (:class:`~repro_torch.sparql.query.ParseError`), 404
(unknown path), 415 (unsupported POST content type), 503 + ``Retry-After``
(:class:`~repro_torch.runtime.admission.AdmissionFullError` — queue full), 504
(:class:`~repro_torch.runtime.admission.DeadlineExceeded`), 500 (engine error).

>>> with SparqlHttpServer(endpoint, window_s=0.002) as srv:
...     urllib.request.urlopen(srv.url + "/sparql?query=" + quote(q))
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlsplit

from ..sparql.algebra import AskNode, SolutionTable
from ..sparql.query import ParseError
from .admission import (AdmissionClosed, AdmissionFullError, AdmissionQueue,
                        DeadlineExceeded)

RESULTS_JSON = "application/sparql-results+json"


def table_to_json(table: SolutionTable) -> dict:
    """:class:`SolutionTable` -> W3C SPARQL JSON results ``dict``.

    Unbound cells are omitted from their row's binding object (the spec's
    representation of OPTIONAL/UNION non-bindings, *not* an empty-string
    binding). Predicate-space variables type as ``uri``, entity-space as
    ``literal`` (see module docstring). Variable names drop the parser's
    leading ``?`` (the spec's bare-name form).
    """
    names = [v.lstrip("?") for v in table.var_names]
    bindings = []
    for row in table.rows(decoded=True):
        b = {}
        for var, name, term in zip(table.var_names, names, row):
            if term is None:
                continue
            kind = "uri" if var in table.pred_vars else "literal"
            b[name] = {"type": kind, "value": term}
        bindings.append(b)
    return {"head": {"vars": names},
            "results": {"bindings": bindings}}


def ask_to_json(table: SolutionTable) -> dict:
    return {"head": {}, "boolean": bool(table.num_matches > 0)}


class _Handler(BaseHTTPRequestHandler):
    # one keep-alive thread per client connection (ThreadingHTTPServer)
    protocol_version = "HTTP/1.1"
    server_version = "repro-torch-sparql/1.0"
    # buffer the whole response (status+headers+body) into ONE socket send
    # (handle_one_request flushes per request): the stdlib default writes
    # headers and body as separate small segments, and Nagle + delayed-ACK
    # turns that into a ~40ms stall per response on loopback
    wbufsize = -1
    disable_nagle_algorithm = True

    # -- plumbing ------------------------------------------------------------
    def log_message(self, fmt, *args):     # noqa: N802 - stdlib name
        pass                               # load tests hammer this; stay quiet

    def _send(self, status: int, payload: dict,
              extra_headers: dict | None = None,
              ctype: str | None = None) -> None:
        body = json.dumps(payload).encode("utf-8")
        self.send_response(status)
        self.send_header("Content-Type", ctype or (
            RESULTS_JSON if status == 200 else "application/json"))
        self.send_header("Content-Length", str(len(body)))
        for k, v in (extra_headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        try:
            self.wfile.write(body)
        except (BrokenPipeError, ConnectionResetError):
            self.close_connection = True   # client went away mid-write

    def _error(self, status: int, message: str,
               extra_headers: dict | None = None) -> None:
        self._send(status, {"error": message}, extra_headers)

    # -- request handling ----------------------------------------------------
    def do_GET(self):                      # noqa: N802 - stdlib name
        url = urlsplit(self.path)
        if url.path == "/healthz":
            self._send(200, {"ok": True})
            return
        if url.path == "/stats":
            self._send(200, self.server.front.stats_dict())
            return
        if url.path != "/sparql":
            self._error(404, f"no route {url.path!r}")
            return
        params = parse_qs(url.query)
        query = params.get("query", [None])[0]
        if not query:
            self._error(400, "missing 'query' parameter")
            return
        self._serve_query(query, params)

    def do_POST(self):                     # noqa: N802 - stdlib name
        url = urlsplit(self.path)
        if url.path not in ("/sparql", "/update"):
            self._error(404, f"no route {url.path!r}")
            return
        ctype = self.headers.get("Content-Type", "").split(";")[0].strip()
        length = int(self.headers.get("Content-Length", 0))
        body = self.rfile.read(length).decode("utf-8") if length else ""
        params = parse_qs(url.query)
        if url.path == "/update" and ctype not in (
                "application/sparql-update",
                "application/x-www-form-urlencoded"):
            self._error(415, f"unsupported content type {ctype!r} for "
                        "/update; use application/sparql-update or "
                        "application/x-www-form-urlencoded")
            return
        if ctype == "application/sparql-query":
            query = body
        elif ctype == "application/sparql-update":
            if not body:
                self._error(400, "missing update body")
                return
            self._serve_update(body, params)
            return
        elif ctype == "application/x-www-form-urlencoded":
            form = parse_qs(body)
            for k in ("timeout", "user"):      # form fields join URL params
                if k in form:
                    params.setdefault(k, form[k])
            update = form.get("update", [None])[0]
            if update:
                self._serve_update(update, params)
                return
            if url.path == "/update":
                self._error(400, "missing 'update' field")
                return
            query = form.get("query", [None])[0]
        else:
            self._error(415, f"unsupported content type {ctype!r}; use "
                        "application/sparql-query, "
                        "application/sparql-update or "
                        "application/x-www-form-urlencoded")
            return
        if not query:
            self._error(400, "missing query")
            return
        self._serve_query(query, params)

    def _serve_query(self, query: str, params: dict) -> None:
        front: SparqlHttpServer = self.server.front
        try:
            timeout = params.get("timeout", [None])[0]
            timeout_s = float(timeout) if timeout is not None else None
            user = int(params.get("user", ["0"])[0])
        except ValueError:
            self._error(400, "non-numeric 'timeout' or 'user' parameter")
            return
        try:
            is_ask = isinstance(front.endpoint.parse(query), AskNode)
            table = front.queue.query(query, user=user,
                                      timeout_s=timeout_s)
        except ParseError as err:
            self._error(400, f"parse error: {err}")
            return
        except AdmissionFullError as err:
            self._error(503, str(err),
                        {"Retry-After": f"{err.retry_after_s:.3f}"})
            return
        except DeadlineExceeded as err:
            self._error(504, str(err))
            return
        except AdmissionClosed:
            self._error(503, "server shutting down")
            return
        except Exception as err:           # engine-level failure
            self._error(500, f"{type(err).__name__}: {err}")
            return
        self._send(200, ask_to_json(table) if is_ask
                   else table_to_json(table))

    def _serve_update(self, text: str, params: dict) -> None:
        """``application/sparql-update`` / form ``update=``: the write goes
        through the SAME admission queue as queries — the ticket resolves
        to the ingest ack only after every query sharing its micro-batch
        window has read the pre-write store."""
        front: SparqlHttpServer = self.server.front
        try:
            timeout = params.get("timeout", [None])[0]
            timeout_s = float(timeout) if timeout is not None else None
            user = int(params.get("user", ["0"])[0])
        except ValueError:
            self._error(400, "non-numeric 'timeout' or 'user' parameter")
            return
        try:
            ack = front.queue.query(text, user=user, timeout_s=timeout_s)
        except ParseError as err:
            self._error(400, f"parse error: {err}")
            return
        except AdmissionFullError as err:
            self._error(503, str(err),
                        {"Retry-After": f"{err.retry_after_s:.3f}"})
            return
        except DeadlineExceeded as err:
            self._error(504, str(err))
            return
        except AdmissionClosed:
            self._error(503, "server shutting down")
            return
        except Exception as err:           # ingest-level failure
            self._error(500, f"{type(err).__name__}: {err}")
            return
        self._send(200, dict(ack), ctype="application/json")


class _Server(ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True
    # socketserver's default listen backlog is 5: a burst of concurrent
    # clients overflows it and the dropped SYNs come back as 1s+ TCP
    # retransmit stalls — exactly the traffic shape this front end exists
    # to coalesce
    request_queue_size = 128
    front: "SparqlHttpServer"


class SparqlHttpServer:
    """The serving front end: HTTP listener + admission queue + endpoint.

    ``port=0`` (default) binds an ephemeral port — read :attr:`url` after
    :meth:`start`. Admission knobs (``window_s``, ``max_batch``,
    ``max_queue``, ``default_timeout_s``, ``mode``) pass straight through
    to :class:`~repro_torch.runtime.admission.AdmissionQueue`; an existing queue
    can be supplied via ``queue=`` instead.
    """

    def __init__(self, endpoint, *, host: str = "127.0.0.1", port: int = 0,
                 queue: AdmissionQueue | None = None, **admission_kw) -> None:
        self.endpoint = endpoint
        if queue is not None and admission_kw:
            raise ValueError("pass admission knobs OR a prebuilt queue, "
                             "not both")
        self.queue = queue or AdmissionQueue(endpoint, **admission_kw)
        self._owns_queue = queue is None
        self._httpd = _Server((host, port), _Handler)
        self._httpd.front = self
        self._thread: threading.Thread | None = None

    # -- lifecycle -----------------------------------------------------------
    @property
    def address(self) -> tuple[str, int]:
        return self._httpd.server_address[:2]

    @property
    def url(self) -> str:
        host, port = self.address
        return f"http://{host}:{port}"

    def start(self) -> "SparqlHttpServer":
        if self._thread is not None:
            return self
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="sparql-http", daemon=True)
        self._thread.start()
        return self

    def stop(self, drain: bool = True) -> None:
        if self._thread is not None:
            self._httpd.shutdown()
            self._thread.join(5.0)
            self._thread = None
        self._httpd.server_close()
        if self._owns_queue:
            self.queue.close(drain=drain)

    def __enter__(self) -> "SparqlHttpServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- introspection -------------------------------------------------------
    def stats_dict(self) -> dict:
        q = self.queue
        es = self.endpoint.stats
        last = q.stats.recent[-1] if q.stats.recent else None
        return {
            "admission": q.stats.as_dict(),
            "queue_depth": q.depth,
            "window_s": q.window_s, "max_batch": q.max_batch,
            "mode": q.mode,
            "endpoint_memo": {"hits": self.endpoint.memo_hits,
                              "misses": self.endpoint.memo_misses},
            "engine": {"cache_hits": es.cache_hits,
                       "cache_misses": es.cache_misses,
                       "scans_executed": es.scans_executed,
                       "scans_deduped": es.scans_deduped},
            "last_batch": None if last is None else {
                "seq": last.seq, "size": last.size,
                "unique_texts": last.unique_texts,
                "expired": last.expired,
                "queue_depth": last.queue_depth,
                "window_fill": round(last.window_fill, 4),
                "wait_seconds": round(last.wait_seconds, 6),
                "exec_seconds": round(last.exec_seconds, 6),
                "memo_hits": last.memo_hits,
                "engine_cache_hits": last.engine_cache_hits,
                "scans_deduped": last.scans_deduped,
            },
        }
