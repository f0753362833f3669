"""HTTP serving front end over the port's continuous-batching engine (port of
unimedvl_tpu/inference/server.py; standard library only).

- :class:`ServingDaemon`: a background thread drives engine rounds
  (admission, one image segment, one decode chunk) continuously; callers
  submit from any thread and wait on per-request tickets. Only the daemon
  thread touches the engine: submissions land in an inbox drained at round
  boundaries, so an HTTP handler never waits on device work to enqueue. Grad
  mode is per thread in PyTorch, so the loop runs under ``torch.no_grad()``.
- :func:`make_server`: a ``ThreadingHTTPServer`` with the routes
    POST /v1/generate  {"prompt", "max_new_tokens"?, "image_png_b64"?,
                        "prefix_id"?, "async"?} -> {"text"} (or 202 {"ticket"})
    POST /v1/images    {"prompt", "height"?, "width"?, denoise options...,
                        "async"?} -> {"image_png_b64", "height", "width"} (or ticket)
    POST /v1/prefixes  {"text"} -> {"prefix_id"}
    GET  /v1/result/<ticket>[?timeout=s] -> the result, or 202 pending with
                        the text decoded so far ("partial")
    POST /v1/cancel    {"ticket"} -> {"cancelled"}
    GET  /v1/health    -> {"ok", "queued", "stats"}
  Text and image requests share the one engine. Cancellation reaches a
  pending request before any device work and an in-flight one at the next
  round boundary.

On a mesh (``ServingDaemon(batcher, mesh=...)``, the batcher a
``ContinuousBatcher(mesh=)`` on every rank) rank 0 runs the HTTP front end
and the queue. Each round it broadcasts that round's events to every rank
(submits, cancels, prefix registrations, stop: a pickled byte tensor, its
length first, over the default process group); every rank applies them in
the same order and steps its engine (:meth:`ServingDaemon.follow` on the
other ranks), so the host states stay equal and the collectives of each
round meet. Only rank 0 answers.
"""

from __future__ import annotations

import base64
import io
import json
import pickle
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional, Tuple

import torch
from PIL import Image

from unimedvl_tpu_torch.inference.serving import ContinuousBatcher, Request

#: the denoise options a /v1/images request may set
GEN_KNOBS = ("cfg_text_scale", "cfg_img_scale", "num_timesteps", "timestep_shift",
             "cfg_renorm_min", "cfg_renorm_type")


class ServingDaemon:
    """The engine's loop on a thread of its own, with thread-safe submit,
    result, cancel and partial-text tickets."""

    def __init__(self, batcher: ContinuousBatcher, idle_wait_s: float = 0.02, mesh=None):
        self.batcher = batcher
        self.idle_wait_s = idle_wait_s
        #: the mesh the batcher runs on; with several ranks each round's events fan out
        self.mesh = mesh if mesh is not None and _world(mesh) > 1 else None
        self._prefix_inbox = []  # [(waiter id, text)], registered by the loop thread on a mesh
        self._prefix_ids: Dict[int, int] = {}  # waiter id -> prefix id
        self._stop_sent = False
        self._cv = threading.Condition()
        self._inbox = []  # [(ticket, Request)], drained by the loop thread
        self._results: Dict[int, Tuple[str, object]] = {}  # ticket -> (kind, value)
        self._tickets = iter(range(1 << 62)).__next__
        self._rid_to_ticket: Dict[int, int] = {}
        self._cancel_inbox = []  # tickets, resolved by the loop thread
        self._partials: Dict[int, str] = {}  # ticket -> text so far
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, name="serving-daemon", daemon=True)
        batcher._reset_stats()

    # -- client side ------------------------------------------------------------
    def start(self) -> "ServingDaemon":
        self._thread.start()
        return self

    def stop(self, timeout: float = 30.0) -> None:
        """Stop the loop (on a mesh, rank 0's: the stop reaches the other
        ranks as the last round's event)."""
        self._stop.set()
        with self._cv:
            self._cv.notify_all()
        self._thread.join(timeout=timeout)

    def submit(self, request: Request) -> int:
        """Enqueue from any thread; returns a ticket at once."""
        with self._cv:
            t = self._tickets()
            self._inbox.append((t, request))
            self._cv.notify_all()
            return t

    def result(self, ticket: int, timeout: Optional[float] = None):
        """Wait until the ticket resolves: (kind, value), kind one of "ok"
        (value: the answer text or a PIL image), "error" or "timeout"."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while ticket not in self._results:
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    return ("timeout", None)
                self._cv.wait(timeout=self.idle_wait_s if remaining is None else remaining)
                if self._stop.is_set() and ticket not in self._results:
                    return ("error", "daemon stopped")
            return self._results.pop(ticket)

    def cancel(self, ticket: int) -> bool:
        """Cancel from any thread: a ticket still in the inbox is dropped at
        once; one in the engine is cancelled by the loop thread at the next
        round boundary (its result becomes ("error", "cancelled ...")). False
        for a ticket whose result was already delivered."""
        with self._cv:
            for i, (t, _req) in enumerate(self._inbox):
                if t == ticket:
                    del self._inbox[i]
                    self._results[ticket] = ("error", "cancelled before start")
                    self._cv.notify_all()
                    return True
            if ticket in self._results or ticket not in self._rid_to_ticket.values():
                return False
            self._cancel_inbox.append(ticket)
            self._cv.notify_all()
            return True

    def register_prefix(self, text: str, timeout: Optional[float] = 600.0) -> int:
        """Register a shared preamble (a prefill). On a mesh the loop thread
        registers it on every rank at a round boundary; this waits for it."""
        if self.mesh is None:
            return self.batcher.register_prefix(text)
        with self._cv:
            w = self._tickets()
            self._prefix_inbox.append((w, text))
            self._cv.notify_all()
            if not self._cv.wait_for(lambda: w in self._prefix_ids or self._stop.is_set(),
                                     timeout=timeout):
                raise TimeoutError("the prefix was not registered in time")
            if w not in self._prefix_ids:
                raise RuntimeError("daemon stopped")
            return self._prefix_ids.pop(w)

    def queued(self) -> int:
        with self._cv:
            return len(self._inbox) + len(self._rid_to_ticket)

    def partial(self, ticket: int) -> Optional[str]:
        """The text decoded so far of an in-flight ticket (None before its
        first tokens, or for an unknown ticket), as of the last round."""
        with self._cv:
            return self._partials.get(ticket)

    # -- loop thread ------------------------------------------------------------
    def _drain(self) -> None:
        with self._cv:
            inbox, self._inbox = self._inbox, []
            cancels, self._cancel_inbox = self._cancel_inbox, []
            prefixes, self._prefix_inbox = self._prefix_inbox, []
        rids = [rid for t in cancels for rid, tt in list(self._rid_to_ticket.items()) if tt == t]
        events = ([("prefix", w, text) for w, text in prefixes]
                  + [("submit", t, req) for t, req in inbox] + [("cancel", rid) for rid in rids])
        if self.mesh is not None:
            stop = self._stop.is_set()
            _broadcast_events(self.batcher, events + ([("stop",)] if stop else []))
            self._stop_sent = stop
        for kind, *rest in events:
            if kind == "submit":
                rid = self.batcher.submit(rest[1])
                with self._cv:
                    self._rid_to_ticket[rid] = rest[0]
            elif kind == "cancel":
                self.batcher.cancel(rest[0])
            else:
                pid = self.batcher.register_prefix(rest[1])
                with self._cv:
                    self._prefix_ids[rest[0]] = pid
                    self._cv.notify_all()
        self._collect()  # rejections at submit, cancellations

    def _collect(self) -> None:
        resolved = {}
        for rid, t in list(self._rid_to_ticket.items()):
            if rid in self.batcher._done:
                resolved[rid] = (t, ("ok", self.batcher._done.pop(rid)))
            elif rid in self.batcher.errors:
                resolved[rid] = (t, ("error", self.batcher.errors[rid]))
        if resolved:
            with self._cv:
                for rid, (t, res) in resolved.items():
                    del self._rid_to_ticket[rid]
                    self._results[t] = res
                self._cv.notify_all()

    def _publish_partials(self) -> None:
        parts = self.batcher.partials()
        with self._cv:
            self._partials = {self._rid_to_ticket[rid]: txt for rid, txt in parts.items()
                              if rid in self._rid_to_ticket}

    def _loop(self) -> None:
        eos = self.batcher.new_token_ids["eos_token_id"]
        with torch.no_grad():  # grad mode is per thread: this one serves
            while not self._stop.is_set():
                self._drain()
                if self._stop_sent:  # the other ranks have left: no further round
                    return
                if self.batcher.has_work():
                    self.batcher._round(self.batcher.stats, eos)
                    self._collect()
                    self._publish_partials()
                else:
                    with self._cv:
                        if not (self._inbox or self._prefix_inbox or self._cancel_inbox
                                or self._stop.is_set()):
                            self._cv.wait(timeout=self.idle_wait_s)
            if self.mesh is not None:
                self._drain()  # the stop reaches the other ranks as a round's event

    def follow(self) -> None:
        """The loop of a rank other than 0 on a mesh: apply rank 0's events of
        each round in its order and step the engine, until the stop event.
        Answers stay here unread (only rank 0 answers); they are dropped."""
        eos = self.batcher.new_token_ids["eos_token_id"]
        b = self.batcher
        with torch.no_grad():
            while True:
                events = _broadcast_events(b, None)
                for kind, *rest in events:
                    if kind == "submit":
                        b.submit(rest[1])
                    elif kind == "cancel":
                        b.cancel(rest[0])
                    elif kind == "prefix":
                        b.register_prefix(rest[1])
                if any(kind == "stop" for kind, *_ in events):
                    return
                if b.has_work():
                    b._round(b.stats, eos)
                b._done.clear()
                b.errors.clear()


def _world(mesh) -> int:
    n = 1
    for a in mesh.axis_names:
        n *= mesh.shape[a]
    return n


def _broadcast_events(batcher: ContinuousBatcher, events):
    """One round's events from rank 0 to every rank of the default process
    group (``events`` None on the others): a pickled byte tensor on the
    engine's device, its length first. Returns the events."""
    import torch.distributed as dist

    device = batcher.device
    if events is not None:
        data = torch.frombuffer(bytearray(pickle.dumps(events)), dtype=torch.uint8).to(device)
        n = torch.tensor([data.numel()], dtype=torch.int64, device=device)
    else:
        n = torch.zeros(1, dtype=torch.int64, device=device)
    dist.broadcast(n, src=0)
    if events is None:
        data = torch.empty(int(n.item()), dtype=torch.uint8, device=device)
    dist.broadcast(data, src=0)
    if events is None:
        events = pickle.loads(data.cpu().numpy().tobytes())
    return events


def _json_response(handler: BaseHTTPRequestHandler, code: int, obj) -> None:
    body = json.dumps(obj).encode()
    handler.send_response(code)
    handler.send_header("Content-Type", "application/json")
    handler.send_header("Content-Length", str(len(body)))
    handler.end_headers()
    handler.wfile.write(body)


def make_server(daemon: ServingDaemon, host: str = "127.0.0.1", port: int = 8000,
                request_timeout_s: float = 600.0) -> ThreadingHTTPServer:
    """Build (not start) the HTTP server: call ``serve_forever()``, or drive
    it from a thread. Each handler thread waits on its daemon ticket."""

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet: the engine keeps its own stats
            pass

        def _read_json(self):
            n = int(self.headers.get("Content-Length", 0))
            return json.loads((self.rfile.read(n) if n else b"") or b"{}")

        def _deliver(self, kind, value):
            if kind == "ok" and isinstance(value, Image.Image):
                buf = io.BytesIO()
                value.save(buf, format="PNG")
                _json_response(self, 200, {
                    "image_png_b64": base64.b64encode(buf.getvalue()).decode(),
                    "height": value.size[1], "width": value.size[0]})
            elif kind == "ok":
                _json_response(self, 200, {"text": value})
            elif kind == "timeout":
                _json_response(self, 504, {"error": "request timed out"})
            else:
                _json_response(self, 502, {"error": str(value)})

        def do_GET(self):
            if self.path == "/v1/health":
                _json_response(self, 200, {"ok": True, "queued": daemon.queued(),
                                           "stats": daemon.batcher.stats})
            elif self.path.startswith("/v1/result/"):
                ticket_s, _, query = self.path[len("/v1/result/"):].partition("?")
                try:
                    ticket = int(ticket_s)
                    wait = float(query[len("timeout="):]) if query.startswith("timeout=") \
                        else 0.5
                except ValueError:
                    return _json_response(self, 400, {"error": "bad ticket"})
                kind, value = daemon.result(ticket, timeout=wait)
                if kind == "timeout":
                    part = daemon.partial(ticket)
                    _json_response(self, 202, {"status": "pending", "ticket": ticket,
                                               **({} if part is None else {"partial": part})})
                else:
                    self._deliver(kind, value)
            else:
                _json_response(self, 404, {"error": f"no route {self.path}"})

        def do_POST(self):
            try:
                payload = self._read_json()
            except Exception as e:
                return _json_response(self, 400, {"error": f"bad json: {e}"})
            try:
                if self.path == "/v1/generate":
                    req = Request(prompt=payload.get("prompt", ""),
                                  max_new_tokens=int(payload.get("max_new_tokens", 128)),
                                  prefix_id=(int(payload["prefix_id"])
                                             if "prefix_id" in payload else None))
                    if payload.get("image_png_b64"):
                        req.image = Image.open(io.BytesIO(
                            base64.b64decode(payload["image_png_b64"])))
                elif self.path == "/v1/prefixes":
                    # register a shared preamble once (a prefill: at start-up or
                    # low traffic); later /v1/generate calls name its prefix_id
                    pid = daemon.register_prefix(payload.get("text", ""))
                    return _json_response(self, 200, {"prefix_id": pid})
                elif self.path == "/v1/images":
                    knobs = {k: payload[k] for k in GEN_KNOBS if k in payload}
                    req = Request(prompt=payload.get("prompt", ""),
                                  image_size=(int(payload.get("height", 512)),
                                              int(payload.get("width", 512))),
                                  gen_params=knobs or None)
                elif self.path == "/v1/cancel":
                    ok = daemon.cancel(int(payload["ticket"]))
                    return _json_response(self, 200 if ok else 409, {
                        "cancelled": ok, **({} if ok else {"error": "already finished"})})
                else:
                    return _json_response(self, 404, {"error": f"no route {self.path}"})
            except Exception as e:
                return _json_response(self, 400, {"error": f"bad request: {e}"})
            ticket = daemon.submit(req)
            if payload.get("async"):
                # poll GET /v1/result/<ticket>; abort with POST /v1/cancel {"ticket": N}
                return _json_response(self, 202, {"ticket": ticket})
            self._deliver(*daemon.result(ticket, timeout=request_timeout_s))

    return ThreadingHTTPServer((host, port), Handler)
