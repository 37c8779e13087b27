"""HTTP serving: query-encoder server, index server, reader server.

The counterpart of ``densephrases_tpu/serve/server.py``, with its names,
routes and JSON bodies (ref: run_demo.py:44-272): a query-encoder service
exposing ``/query2vec_api``, an index service exposing ``/api`` (single
query), ``/batch_api`` (batched), ``/get_examples`` and the demo page at
``/``, and a single-passage reader exposing ``/single_api``. The client
helper ``eval_request`` mirrors the reference's benchmark client (ref:
run_demo.py:318-356): batched queries, 5-batch warmup excluded, Q/sec
reported.

The JAX package serves with tornado; the port serves with the standard
library's ``http.server``, as the JAX package replaced Flask with tornado
because Flask was not installed: tornado is not installed beside the
port's CUDA runtime. An app is a route table (``App``); ``make_server``
binds it to a port and returns the server, whose ``shutdown()`` stops
``serve_forever`` from another thread; ``serve`` is the blocking loop the
drivers call.

One request at a time: the server is an ``HTTPServer``, not a
``ThreadingHTTPServer``. Tornado's IOLoop runs the reference's synchronous
handlers one after another, and two requests at once would share the
model, its CUDA stream and ``FusedServer``'s pinned buffers.
"""

from __future__ import annotations

import json
import logging
import mimetypes
import os
import time
import urllib.parse
import urllib.request
from http.server import BaseHTTPRequestHandler, HTTPServer
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

logger = logging.getLogger(__name__)

STATIC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "static")


def _json_default(o):
    # the port's result dicts hold Python scalars (``MIPS._assemble``,
    # ``read_passages``); numpy values are taken as the reference takes them
    if isinstance(o, (np.integer,)):
        return int(o)
    if isinstance(o, (np.floating,)):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(f"not serializable: {type(o)}")


def _vectors(vecs) -> list:
    """Query vectors (a device tensor, possibly bf16) as host fp32 lists."""
    return vecs.detach().to(device="cpu", dtype=torch.float32).tolist()


class Request:
    """What a handler reads: the query string's arguments and the body."""

    def __init__(self, query: str, body: bytes):
        self.arguments = urllib.parse.parse_qs(query, keep_blank_values=True)
        self.body = body

    def get_argument(self, name: str, default: str) -> str:
        """The last value of ``name``, stripped (tornado's rule)."""
        values = self.arguments.get(name)
        return values[-1].strip() if values else default

    def json(self) -> dict:
        return json.loads(self.body or b"{}")


Handler = Callable[[Request], str]


class App:
    """A route table: ``routes[path][method]`` is a handler that takes a
    ``Request`` and returns the JSON body; with ``static_dir``, any other
    GET path names a file under it (``/`` its ``index.html``)."""

    def __init__(self, routes: Dict[str, Dict[str, Handler]],
                 static_dir: Optional[str] = None):
        self.routes = routes
        self.static_dir = static_dir

    def static_file(self, path: str) -> Optional[str]:
        if self.static_dir is None:
            return None
        root = os.path.realpath(self.static_dir)
        name = urllib.parse.unquote(path).lstrip("/") or "index.html"
        full = os.path.realpath(os.path.join(root, name))
        if os.path.commonpath([root, full]) != root or not os.path.isfile(full):
            return None
        return full


def make_server(app: App, port: int) -> HTTPServer:
    """Bind ``app`` to ``port`` on every interface, as tornado's ``listen``
    does, and return the server, not yet serving."""

    class RequestHandler(BaseHTTPRequestHandler):
        def do_GET(self):
            self._dispatch("GET")

        def do_POST(self):
            self._dispatch("POST")

        def log_message(self, fmt, *args):
            logger.debug("%s " + fmt, self.address_string(), *args)

        def _send(self, status: int, body: bytes, content_type: str):
            self.send_response(status)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _dispatch(self, method: str):
            url = urllib.parse.urlsplit(self.path)
            length = int(self.headers.get("Content-Length") or 0)
            body = self.rfile.read(length) if length else b""
            route = app.routes.get(url.path)
            if route is None:
                path = app.static_file(url.path) if method == "GET" else None
                if path is None:
                    self._send(404, b"Not Found", "text/plain")
                    return
                with open(path, "rb") as f:
                    data = f.read()
                self._send(200, data, mimetypes.guess_type(path)[0]
                           or "application/octet-stream")
                return
            handler = route.get(method)
            if handler is None:
                self._send(405, b"Method Not Allowed", "text/plain")
                return
            try:
                out = handler(Request(url.query, body))
            except Exception:  # noqa: BLE001 — the server keeps serving
                logger.exception("uncaught error serving %s %s", method,
                                 self.path)
                self._send(500, b"Internal Server Error", "text/plain")
                return
            self._send(200, out.encode("utf-8"),
                       "application/json; charset=UTF-8")

    return HTTPServer(("", port), RequestHandler)


def make_query_encoder_app(model) -> App:
    """Query-encoder service: POST /query2vec_api {'query': [str]} →
    {'vec': [[...]]} (ref: run_demo.py:44-68)."""

    def post(req: Request) -> str:
        queries = req.json().get("query", [])
        if isinstance(queries, str):
            queries = [queries]
        return json.dumps({"vec": _vectors(model.query2vec(queries))})

    def get(req: Request) -> str:
        q = req.get_argument("query", "")
        return json.dumps({"vec": _vectors(model.query2vec([q]))})

    return App({"/query2vec_api": {"GET": get, "POST": post}})


class RemoteQueryEncoder:
    """query2vec over HTTP against a q_serve process — the reference's
    two-process split where the index server RPCs the encoder server
    (ref: run_demo.py:278-316 FuturesSession embed_query)."""

    def __init__(self, host: str, port: int):
        self.url = f"http://{host}:{port}/query2vec_api"

    def query2vec(self, queries: List[str]) -> np.ndarray:
        req = urllib.request.Request(
            self.url, data=json.dumps({"query": queries}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req) as resp:
            return np.asarray(json.loads(resp.read())["vec"], np.float32)


def make_index_app(model, default_top_k: int = 10,
                   examples: Optional[List[str]] = None,
                   remote_encoder: Optional[RemoteQueryEncoder] = None,
                   fused: bool = True) -> App:
    """Index service: GET /api?query=...&retrieval_unit=...; POST /batch_api
    (ref: run_demo.py:70-149). With remote_encoder, query vectors come from
    a separate q_serve process over HTTP (two-process mode). With fused
    (default) and a single-device int8 FlatIndex, phrase queries go through
    ``FusedServer`` (one sync point a batch); any other index takes the
    modular route."""
    fused_server = None
    if fused and remote_encoder is None:
        from densephrases_tpu_torch.serve.fused import FusedServer

        try:
            fused_server = FusedServer(model)
            logger.info("index app: fused serve path active")
        except AssertionError:  # FusedServer's refusal: the modular route
            fused_server = None

    def do_search(queries, top_k, unit):
        if fused_server is not None and unit == "phrase":
            rets_all = fused_server.search(queries, top_k=top_k,
                                           aggregate=True)
            answers = [[r["answer"] for r in ret[:top_k]] for ret in rets_all]
            rets = [ret[:top_k] for ret in rets_all]
        elif remote_encoder is not None:
            qvec = remote_encoder.query2vec(queries)
            search_k = top_k if unit == "phrase" else top_k * 2
            rets_all = model.mips.search(
                qvec, q_texts=queries, top_k=search_k, aggregate=True,
                agg_strat=model.UNIT_TO_STRAT.get(unit, "opt1"),
                return_sent=(unit == "sentence"))
            # per-unit extraction, as DensePhrases.search does: phrase →
            # answer span, sentence/paragraph → context, document → title
            if unit in ("sentence", "paragraph"):
                answers = [[r["context"] for r in ret[:top_k]] for ret in rets_all]
            elif unit == "document":
                answers = [[r["title"][0] for r in ret[:top_k]] for ret in rets_all]
            else:
                answers = [[r["answer"] for r in ret[:top_k]] for ret in rets_all]
            rets = [ret[:top_k] for ret in rets_all]
        else:
            answers, rets = model.search(
                queries, retrieval_unit=unit, top_k=top_k, return_meta=True)
        out = []
        for ans, ret in zip(answers, rets):
            out.append([{
                "answer": r.get("answer", ""), "context": r["context"],
                "title": r["title"], "score": r["score"],
                "start_pos": r.get("start_pos", 0),
                "end_pos": r.get("end_pos", 0),
            } for r in ret])
        return answers, out

    def api(req: Request) -> str:
        t0 = time.time()
        q = req.get_argument("query", "")
        top_k = int(req.get_argument("top_k", str(default_top_k)))
        unit = req.get_argument("retrieval_unit", "phrase")
        answers, rets = do_search([q], top_k, unit)
        return json.dumps({
            "ret": rets[0], "answers": answers[0],
            "time": int(1000 * (time.time() - t0)),
        }, default=_json_default)

    def batch_api(req: Request) -> str:
        body = req.json()
        queries = body.get("query", [])
        top_k = int(body.get("top_k", default_top_k))
        unit = body.get("retrieval_unit", "phrase")
        t0 = time.time()
        answers, rets = do_search(queries, top_k, unit)
        return json.dumps({
            "ret": rets, "answers": answers,
            "time": int(1000 * (time.time() - t0)),
        }, default=_json_default)

    def get_examples(req: Request) -> str:
        return json.dumps({"examples": examples or []})

    return App({"/api": {"GET": api}, "/batch_api": {"POST": batch_api},
                "/get_examples": {"GET": get_examples}},
               static_dir=STATIC_DIR)


def make_reader_app(cross_params, config, tokenizer,
                    attn_impl: str = "auto") -> App:
    """Single-passage reading service: POST /single_api
    {'question': str|[str], 'passage': str|[str]} → extracted answers
    (ref: run_demo.py:151-272 serve_bert_encoder)."""
    from densephrases_tpu_torch.eval.reader import read_passages

    def single_api(req: Request) -> str:
        body = req.json()
        qs = body.get("question", [])
        ps = body.get("passage", [])
        if isinstance(qs, str):
            qs = [qs]
        if isinstance(ps, str):
            ps = [ps]
        t0 = time.time()
        out = read_passages(cross_params, config, tokenizer, qs, ps,
                            attn_impl=attn_impl)
        return json.dumps({
            "ret": out, "time": int(1000 * (time.time() - t0)),
        }, default=_json_default)

    return App({"/single_api": {"POST": single_api}})


def serve(app: App, port: int, *,
          started: Optional[Callable[[HTTPServer], None]] = None):
    """Blocking serve loop. ``started``, when given, receives the server
    before it serves, so that another thread can ``shutdown()`` it."""
    server = make_server(app, port)
    logger.info("serving on :%d", port)
    if started is not None:
        started(server)
    try:
        server.serve_forever()
    finally:
        server.server_close()


def eval_request(host: str, port: int, qa_pairs, batch_size: int = 64,
                 top_k: int = 10, warmup_batches: int = 5):
    """Benchmark client: EM@1 + Q/sec with warmup excluded
    (ref: run_demo.py:318-356)."""
    from densephrases_tpu_torch.eval.retrieval import evaluate_predictions

    questions = [q for q, _ in qa_pairs]
    answers = [a for _, a in qa_pairs]
    url = f"http://{host}:{port}/batch_api"

    def call(batch):
        req = urllib.request.Request(
            url, data=json.dumps({"query": batch, "top_k": top_k}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req) as resp:
            return json.loads(resp.read())

    preds = []
    n_q, elapsed = 0, 0.0
    for i, b0 in enumerate(range(0, len(questions), batch_size)):
        batch = questions[b0: b0 + batch_size]
        t0 = time.time()
        out = call(batch)
        dt = time.time() - t0
        if i >= warmup_batches:
            n_q += len(batch)
            elapsed += dt
        preds.extend(out["answers"])
    qps = n_q / elapsed if elapsed > 0 else float("nan")
    metrics = evaluate_predictions(preds, answers)
    metrics["qps"] = qps
    logger.info("EM@1 %.2f | %.1f Q/sec", metrics["em_top1"], qps)
    return metrics
