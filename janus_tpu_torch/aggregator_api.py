"""Ops/control-plane REST API.

Equivalent of reference aggregator_api/src/lib.rs:69-122: an internal
JSON API on a separate listener, bearer-token authenticated, for task
CRUD, task metrics, global HPKE key management, and taskprov peer
management. DTOs are the Task/PeerAggregator dict forms (the analog of
aggregator_api/src/models.rs).

Routes:
  GET    /                                    -> version doc
  GET    /task_ids[?pagination_token=...]     -> paginated task ids
  POST   /tasks                               -> create (fills defaults)
  GET    /tasks/:task_id                      -> task doc (no HPKE privkeys)
  DELETE /tasks/:task_id
  GET    /tasks/:task_id/metrics              -> report counts
  GET    /hpke_configs                        -> global HPKE keypairs
  PUT    /hpke_configs                        -> generate one {config_id?}
  PATCH  /hpke_configs/:config_id             -> {state: pending|active|expired}
  DELETE /hpke_configs/:config_id
  GET    /taskprov/peer_aggregators           -> peers
  PUT    /taskprov/peer_aggregators           -> upsert peer doc
  DELETE /taskprov/peer_aggregators           -> {endpoint, role}

The port's own copy of janus_tpu/aggregator_api.py: the same routes,
statuses, documents and bearer-token check, over the port's datastore.
"""

from __future__ import annotations

import base64
import json
import re
import secrets
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .core.hpke import generate_hpke_config_and_private_key
from .datastore.store import Datastore
from .messages import Role, TaskId
from .task import Task
from .taskprov import PeerAggregator

# bytes of a Prio3 verify key (reference core/src/task.rs:15)
VERIFY_KEY_LENGTH = 16


def _b64(b: bytes) -> str:
    return base64.urlsafe_b64encode(b).decode().rstrip("=")


def _unb64(s: str) -> bytes:
    return base64.urlsafe_b64decode(s + "=" * (-len(s) % 4))


class ApiError(Exception):
    def __init__(self, status: int, detail: str):
        super().__init__(detail)
        self.status = status
        self.detail = detail


PAGE_SIZE = 10  # reference aggregator_api task_ids pagination


class AggregatorApi:
    """Route logic, transport-free (tested directly; served below)."""

    def __init__(self, ds: Datastore, auth_tokens=()):
        self.ds = ds
        self.auth_tokens = tuple(auth_tokens)

    # --- auth ---
    def check_auth(self, headers) -> None:
        if not self.auth_tokens:
            raise ApiError(401, "no API auth tokens configured")
        got = (headers.get("Authorization") or "").removeprefix("Bearer ").strip()
        import hmac

        for tok in self.auth_tokens:
            raw = tok.token if hasattr(tok, "token") else str(tok)
            if hmac.compare_digest(got.encode(), raw.encode()):
                return
        raise ApiError(401, "invalid bearer token")

    # --- handlers ---
    def get_root(self):
        return {"protocol": "DAP-07", "server": "janus_tpu_torch"}

    def get_task_ids(self, pagination_token: str | None):
        ids = sorted(_b64(t.data) for t in self.ds.run_tx(lambda tx: tx.get_task_ids()))
        if pagination_token:
            ids = [i for i in ids if i > pagination_token]
        page, rest = ids[:PAGE_SIZE], ids[PAGE_SIZE:]
        doc = {"task_ids": page}
        if rest:
            doc["pagination_token"] = page[-1]
        return doc

    def post_task(self, doc: dict):
        doc = dict(doc)
        doc.setdefault("task_id", _b64(secrets.token_bytes(32)))
        doc.setdefault("vdaf_verify_key", _b64(secrets.token_bytes(VERIFY_KEY_LENGTH)))
        doc.setdefault("max_batch_query_count", 1)
        doc.setdefault("min_batch_size", 1)
        doc.setdefault("tolerable_clock_skew", 60)
        if doc.get("role") == int(Role.HELPER) and not doc.get("hpke_keys"):
            kp = generate_hpke_config_and_private_key(config_id=0)
            doc["hpke_keys"] = [
                {
                    "config": base64.urlsafe_b64encode(kp.config.to_bytes()).decode(),
                    "private_key": _b64(kp.private_key),
                }
            ]
        try:
            task = Task.from_dict(doc)
        except (KeyError, ValueError, AssertionError) as e:
            raise ApiError(400, f"invalid task document: {e!r}")
        self.ds.run_tx(lambda tx: tx.put_task(task), "api_post_task")
        return self._task_resp(task)

    def _task_resp(self, task: Task) -> dict:
        doc = task.to_dict()
        # never expose HPKE private keys over the ops API
        doc["hpke_keys"] = [k["config"] for k in doc["hpke_keys"]]
        return doc

    def _get_task(self, task_id_s: str) -> Task:
        try:
            tid = TaskId(_unb64(task_id_s))
        except Exception:
            raise ApiError(400, "malformed task id")
        task = self.ds.run_tx(lambda tx: tx.get_task(tid))
        if task is None:
            raise ApiError(404, "no such task")
        return task

    def get_task(self, task_id_s: str):
        return self._task_resp(self._get_task(task_id_s))

    def delete_task(self, task_id_s: str):
        task = self._get_task(task_id_s)
        self.ds.run_tx(lambda tx: tx.delete_task(task.task_id), "api_delete_task")
        return None

    def get_task_metrics(self, task_id_s: str):
        task = self._get_task(task_id_s)
        total, started = self.ds.run_tx(
            lambda tx: tx.count_client_reports_for_task(task.task_id)
        )
        return {"reports": total, "report_aggregations": started}

    # --- global HPKE configs ---
    def get_hpke_configs(self):
        rows = self.ds.run_tx(lambda tx: tx.get_global_hpke_keypairs())
        return [
            {"config": base64.urlsafe_b64encode(kp.config.to_bytes()).decode(), "state": state}
            for kp, state in rows
        ]

    def put_hpke_config(self, doc: dict):
        config_id = doc.get("config_id")
        if config_id is None:
            taken = {
                kp.config.id.id
                for kp, _ in self.ds.run_tx(lambda tx: tx.get_global_hpke_keypairs())
            }
            free = [i for i in range(256) if i not in taken]
            if not free:
                raise ApiError(400, "all 256 HPKE config ids are in use")
            config_id = free[0]
        elif not 0 <= int(config_id) < 256:
            raise ApiError(400, "config_id must be in [0, 255]")
        kp = generate_hpke_config_and_private_key(config_id=int(config_id))
        self.ds.run_tx(lambda tx: tx.put_global_hpke_keypair(kp), "api_put_hpke")
        return {
            "config": base64.urlsafe_b64encode(kp.config.to_bytes()).decode(),
            "state": "pending",
        }

    def patch_hpke_config(self, config_id: int, doc: dict):
        state = doc.get("state")
        if state not in ("pending", "active", "expired"):
            raise ApiError(400, "state must be pending|active|expired")
        self.ds.run_tx(
            lambda tx: tx.set_global_hpke_keypair_state(config_id, state),
            "api_patch_hpke",
        )
        return None

    def delete_hpke_config(self, config_id: int):
        self.ds.run_tx(
            lambda tx: tx.delete_global_hpke_keypair(config_id), "api_delete_hpke"
        )
        return None

    # --- taskprov peers ---
    def get_peers(self):
        peers = self.ds.run_tx(lambda tx: tx.get_taskprov_peer_aggregators())
        return [p.to_dict() for p in peers]

    def put_peer(self, doc: dict):
        try:
            peer = PeerAggregator.from_dict(doc)
        except (KeyError, ValueError, AssertionError) as e:
            raise ApiError(400, f"invalid peer document: {e!r}")
        self.ds.run_tx(lambda tx: tx.put_taskprov_peer_aggregator(peer), "api_put_peer")
        return peer.to_dict()

    def delete_peer(self, doc: dict):
        try:
            endpoint, role = doc["endpoint"], Role(doc["role"])
        except (KeyError, ValueError) as e:
            raise ApiError(400, f"invalid peer selector: {e!r}")
        self.ds.run_tx(
            lambda tx: tx.delete_taskprov_peer_aggregator(endpoint, role),
            "api_delete_peer",
        )
        return None

    # --- dispatch ---
    ROUTES = [
        ("GET", re.compile(r"^/$"), "get_root"),
        ("GET", re.compile(r"^/task_ids$"), "get_task_ids"),
        ("POST", re.compile(r"^/tasks$"), "post_task"),
        ("GET", re.compile(r"^/tasks/([^/]+)$"), "get_task"),
        ("DELETE", re.compile(r"^/tasks/([^/]+)$"), "delete_task"),
        ("GET", re.compile(r"^/tasks/([^/]+)/metrics$"), "get_task_metrics"),
        ("GET", re.compile(r"^/hpke_configs$"), "get_hpke_configs"),
        ("PUT", re.compile(r"^/hpke_configs$"), "put_hpke_config"),
        ("PATCH", re.compile(r"^/hpke_configs/(\d+)$"), "patch_hpke_config"),
        ("DELETE", re.compile(r"^/hpke_configs/(\d+)$"), "delete_hpke_config"),
        ("GET", re.compile(r"^/taskprov/peer_aggregators$"), "get_peers"),
        ("PUT", re.compile(r"^/taskprov/peer_aggregators$"), "put_peer"),
        ("DELETE", re.compile(r"^/taskprov/peer_aggregators$"), "delete_peer"),
    ]

    def handle(self, method: str, path: str, query: dict, headers, body: bytes):
        """-> (status, json-serializable doc or None)."""
        try:
            self.check_auth(headers)
            for m, pat, name in self.ROUTES:
                match = pat.match(path)
                if m == method and match:
                    return self._invoke(name, match, query, body)
            raise ApiError(404, "no such route")
        except ApiError as e:
            return e.status, {"status": e.status, "detail": e.detail}
        except Exception as e:  # never drop the connection on a handler bug
            return 500, {"status": 500, "detail": f"internal error: {type(e).__name__}"}

    def _invoke(self, name: str, match, query: dict, body: bytes):
        try:
            doc = json.loads(body) if body else {}
        except json.JSONDecodeError as e:
            raise ApiError(400, f"malformed JSON body: {e}")
        if name == "get_task_ids":
            return 200, self.get_task_ids(query.get("pagination_token"))
        if name == "post_task":
            return 201, self.post_task(doc)
        if name == "get_task":
            return 200, self.get_task(match.group(1))
        if name == "delete_task":
            return 204, self.delete_task(match.group(1))
        if name == "get_task_metrics":
            return 200, self.get_task_metrics(match.group(1))
        if name == "put_hpke_config":
            return 201, self.put_hpke_config(doc)
        if name == "patch_hpke_config":
            return 200, self.patch_hpke_config(int(match.group(1)), doc)
        if name == "delete_hpke_config":
            return 204, self.delete_hpke_config(int(match.group(1)))
        if name == "put_peer":
            return 201, self.put_peer(doc)
        if name == "delete_peer":
            return 204, self.delete_peer(doc)
        return 200, getattr(self, name)()


class AggregatorApiServer:
    """Threaded HTTP shell around AggregatorApi."""

    def __init__(self, api: AggregatorApi, host: str = "127.0.0.1", port: int = 0):
        from urllib.parse import parse_qsl, urlsplit

        class Handler(BaseHTTPRequestHandler):
            def _dispatch(self, method):
                parts = urlsplit(self.path)
                query = dict(parse_qsl(parts.query))
                n = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(n) if n else b""
                status, doc = api.handle(method, parts.path, query, self.headers, body)
                out = json.dumps(doc).encode() if doc is not None else b""
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(out)))
                self.end_headers()
                if out:
                    self.wfile.write(out)

            def do_GET(self):  # noqa: N802
                self._dispatch("GET")

            def do_POST(self):  # noqa: N802
                self._dispatch("POST")

            def do_PUT(self):  # noqa: N802
                self._dispatch("PUT")

            def do_PATCH(self):  # noqa: N802
                self._dispatch("PATCH")

            def do_DELETE(self):  # noqa: N802
                self._dispatch("DELETE")

            def log_message(self, fmt, *args):
                pass

        self._srv = ThreadingHTTPServer((host, port), Handler)
        self._thread = threading.Thread(
            target=self._srv.serve_forever, name="api-listener", daemon=True
        )

    @property
    def url(self) -> str:
        host, port = self._srv.server_address[:2]
        return f"http://{host}:{port}"

    def start(self) -> "AggregatorApiServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._srv.shutdown()
        self._srv.server_close()
