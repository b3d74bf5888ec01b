"""HTTP serving: the transport-agnostic :class:`ServingService` JSON API over
the :class:`~.engine.InferenceEngine`, behind a stdlib threaded server.

Endpoints (the JSON wire of the JAX package's ``serving/server.py``)::

    POST /v1/weights  {"individual": [[...]], "mask": [...]?, "month": t?}
                      → {"weights": [...], "month": t, "n": N, ...}
    POST /v1/sdf      same + {"returns": [...]} → {"sdf": F, "member_sdf": [..]}
    POST /v1/macro    {"macro": [...], "raw": false?} — O(1) incremental
                      macro-state advance → {"month": new index}
    GET  /v1/models   ensemble manifest (members, config hash, buckets, ...)
    GET  /healthz     liveness

Until the batcher is ported, a client reaches the batch buckets itself:
``/v1/weights`` and ``/v1/sdf`` also take ``{"batch": [query, ...]}`` and
answer ``{"results": [answer, ...]}``, served as one forward.

    python -m deeplearninginassetpricing_paperreplication_torch.serving.server \\
        --checkpoint_dirs ref_runs/w500 ref_runs/mid2000 --data_dir DATA --port 8787

The server runs on the CUDA device unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..data.panel import load_splits
from .engine import (
    DEFAULT_STOCK_BUCKETS,
    InferenceEngine,
    InferenceRequest,
    InferenceResult,
    bucket_for,
)


class BadRequest(ValueError):
    """Client-side payload problem → HTTP 400."""


class ServingService:
    """The JSON API over an engine, transport-agnostic: the HTTP handler is
    a thin shim over :meth:`handle`, and tests may drive it directly."""

    def __init__(self, engine: InferenceEngine):
        self.engine = engine
        self._started = time.monotonic()

    def handle(self, method: str, path: str,
               payload: Optional[Dict[str, Any]]) -> Tuple[int, Dict]:
        """One request → (http status, response dict). Never raises."""
        endpoint = path.split("?", 1)[0].rstrip("/") or "/"
        try:
            status, body = self._route(method, endpoint, payload)
        except BadRequest as e:
            status, body = 400, {"error": str(e)}
        except Exception as e:  # a bad request must not kill the server
            status, body = 500, {"error": f"{type(e).__name__}: {e}"}
        return status, body

    def _route(self, method, endpoint, payload) -> Tuple[int, Dict]:
        if endpoint == "/healthz":
            return 200, self.healthz()
        if endpoint == "/v1/models":
            return 200, self.models_info()
        if endpoint in ("/v1/weights", "/v1/sdf", "/v1/macro"):
            if method != "POST":
                return 405, {"error": "POST required"}
            if endpoint == "/v1/macro":
                return 200, self._macro_endpoint(payload or {})
            return 200, self._infer_endpoint(endpoint, payload or {})
        return 404, {"error": f"unknown endpoint {endpoint}"}

    # -- endpoints -----------------------------------------------------------

    def _parse_request(self, endpoint: str,
                       payload: Dict[str, Any]) -> InferenceRequest:
        f = self.engine.cfg.individual_feature_dim
        if "individual" not in payload:
            raise BadRequest("payload requires 'individual' ([N, F] floats)")
        try:
            individual = np.asarray(payload["individual"], np.float32)
        except (TypeError, ValueError) as e:
            raise BadRequest(f"bad 'individual': {e}") from e
        if individual.ndim != 2 or individual.shape[1] != f:
            raise BadRequest(f"'individual' must be [N, {f}]; got "
                             f"{list(individual.shape)}")
        n = individual.shape[0]
        mask = returns = None
        try:
            if payload.get("mask") is not None:
                mask = np.asarray(payload["mask"], np.float32)
            if payload.get("returns") is not None:
                returns = np.asarray(payload["returns"], np.float32)
        except (TypeError, ValueError) as e:
            raise BadRequest(f"bad 'mask'/'returns': {e}") from e
        if mask is not None and mask.shape != (n,):
            raise BadRequest("'mask' must be [N]")
        if endpoint == "/v1/sdf" and returns is None:
            raise BadRequest("/v1/sdf requires 'returns' ([N] floats)")
        if returns is not None and returns.shape != (n,):
            raise BadRequest("'returns' must be [N]")
        month = int(payload.get("month", -1))
        if self.engine.state_dim > 0:
            months = self.engine.months
            resolved = month if month >= 0 else months + month
            if not 0 <= resolved < months:
                raise BadRequest(f"month {month} outside the engine's "
                                 f"{months} macro months")
            month = resolved
        try:
            bucket_for(n, self.engine.stock_buckets)
        except ValueError as e:
            raise BadRequest(str(e)) from e
        return InferenceRequest(individual=individual, mask=mask,
                                returns=returns, month=month)

    def _answer(self, endpoint: str, res: InferenceResult) -> Dict[str, Any]:
        body: Dict[str, Any] = {
            "month": res.month, "n": res.n, "bucket": res.bucket,
            "batch_bucket": res.batch_bucket,
            "n_members": self.engine.n_members,
            "config_hash": self.engine.config_hash,
        }
        if endpoint == "/v1/weights":
            body["weights"] = np.asarray(res.weights, np.float64).tolist()
        else:
            body["sdf"] = res.sdf
            body["member_sdf"] = np.asarray(res.member_sdf,
                                            np.float64).tolist()
        return body

    def _infer_endpoint(self, endpoint: str,
                        payload: Dict[str, Any]) -> Dict[str, Any]:
        if "batch" in payload:
            queries = payload["batch"]
            if not isinstance(queries, list) or not queries:
                raise BadRequest("'batch' must be a non-empty list of queries")
            try:
                bucket_for(len(queries), self.engine.batch_buckets)
            except ValueError as e:
                raise BadRequest(str(e)) from e
            reqs = [self._parse_request(endpoint, q) for q in queries]
            results = self.engine.infer(reqs)
            return {"results": [self._answer(endpoint, r) for r in results]}
        req = self._parse_request(endpoint, payload)
        return self._answer(endpoint, self.engine.infer_one(req))

    def _macro_endpoint(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        if "macro" not in payload:
            raise BadRequest("payload requires 'macro' ([M] floats)")
        try:
            month = self.engine.append_month(
                np.asarray(payload["macro"], np.float32),
                raw=bool(payload.get("raw", False)))
        except ValueError as e:
            raise BadRequest(str(e)) from e
        return {"month": month, "months": self.engine.months}

    def models_info(self) -> Dict[str, Any]:
        return {
            "n_members": self.engine.n_members,
            "checkpoint_dirs": self.engine.checkpoint_dirs,
            "config_hash": self.engine.config_hash,
            "config": self.engine.cfg.to_dict(),
            "months": self.engine.months,
            "engine": self.engine.stats(),
        }

    def healthz(self) -> Dict[str, Any]:
        return {"ok": True,
                "uptime_s": round(time.monotonic() - self._started, 3),
                "device": str(self.engine.device),
                "months": self.engine.months}


class _Handler(BaseHTTPRequestHandler):
    # the service is attached to the server object by make_server()
    protocol_version = "HTTP/1.1"

    def _respond(self, status: int, body: Dict) -> None:
        data = json.dumps(body).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _dispatch(self, method: str) -> None:
        payload = None
        if method == "POST":
            length = int(self.headers.get("Content-Length") or 0)
            if length:
                try:
                    payload = json.loads(self.rfile.read(length))
                except json.JSONDecodeError:
                    self._respond(400, {"error": "request body is not "
                                                 "valid JSON"})
                    return
        status, body = self.server.service.handle(method, self.path, payload)
        self._respond(status, body)

    def do_GET(self):  # noqa: N802 (stdlib handler API)
        self._dispatch("GET")

    def do_POST(self):  # noqa: N802
        self._dispatch("POST")

    def log_message(self, fmt, *args):  # keep stdout for the startup lines
        pass


def make_server(service: ServingService, host: str = "127.0.0.1",
                port: int = 0) -> ThreadingHTTPServer:
    """Bind a ThreadingHTTPServer for `service`; port 0 picks a free port
    (``server.server_address[1]`` has the real one). The caller runs
    ``serve_forever()`` (typically on a thread) and ``shutdown()``s."""
    httpd = ThreadingHTTPServer((host, port), _Handler)
    httpd.service = service
    return httpd


# -- CLI ---------------------------------------------------------------------


def build_arg_parser() -> argparse.ArgumentParser:
    from ..evaluate_ensemble import add_execution_args

    p = argparse.ArgumentParser(
        description="Serve an SDF checkpoint ensemble over HTTP")
    p.add_argument("--checkpoint_dirs", type=str, nargs="+", required=True,
                   help="member run dirs (config.json + best_model_sharpe.pt)")
    p.add_argument("--data_dir", type=str, default=None,
                   help="panel dir; the serving macro history comes from "
                        "--macro_split (normalized with train stats)")
    p.add_argument("--macro_split", type=str, default="test",
                   choices=("train", "valid", "test"))
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8787)
    add_execution_args(p)
    return p


def build_service(args: argparse.Namespace) -> ServingService:
    """Load the macro history and the ensemble and warm every bucket: the
    service `main` serves. The stock-bucket ladder is capped at the panel's
    stock count, so warmup runs only buckets this deployment can hit."""
    from ..evaluate_ensemble import execution_config

    exec_cfg = execution_config(args)  # fails before any loading
    kwargs: Dict[str, Any] = {}
    if args.data_dir:
        splits = dict(zip(("train", "valid", "test"),
                          load_splits(args.data_dir)))
        train = splits["train"]
        kwargs["macro_history"] = splits[args.macro_split].macro
        kwargs["macro_stats"] = (train.mean_macro, train.std_macro)
        top = bucket_for(max(s.N for s in splits.values()),
                         DEFAULT_STOCK_BUCKETS)
        kwargs["stock_buckets"] = tuple(
            b for b in DEFAULT_STOCK_BUCKETS if b <= top)
    engine = InferenceEngine(args.checkpoint_dirs, exec_cfg=exec_cfg,
                             **kwargs)
    service = ServingService(engine)
    n = engine.warmup()
    print(f"warmed {n} buckets (stock buckets {list(engine.stock_buckets)}, "
          f"batch buckets {list(engine.batch_buckets)}) on {engine.device}",
          flush=True)
    return service


def main(argv: Optional[List[str]] = None) -> int:
    args = build_arg_parser().parse_args(argv)
    service = build_service(args)
    engine = service.engine
    httpd = make_server(service, args.host, args.port)
    host, port = httpd.server_address[:2]
    print(f"serving {engine.n_members} members on http://{host}:{port} "
          f"(config {engine.config_hash[:12]}, {engine.device}, "
          f"{engine.exec_cfg.compute_dtype})", flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
