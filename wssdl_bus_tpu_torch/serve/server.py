"""Stdlib-only HTTP detection server over a serving artifact (counterpart
of ``wssdl_bus_tpu/serve/server.py``).  Run::

    python -m wssdl_bus_tpu_torch.serve.server --artifact /tmp/artifact \
        --port 8000 [--device cpu]

It serves on CUDA unless ``--device`` names another device, and raises
without a card.

Endpoints:

  ``GET  /healthz``         -> {"status": "ok", platform, device,
        batch_sizes, ...}
  ``GET  /metrics``         -> request/error counts, device-step batch-size
        histogram, and request-latency quantiles (JSON; cheap enough to
        poll)
  ``POST /detect[?thresh=T]`` with an image file (PNG/TIFF/JPEG bytes) as
        the request body -> {"detections": [{"class", "score", "box"}, ...]}
        in original pixel coordinates (same post-processing and schema as
        ``main/predict.py`` — shared ``serve.report_detections``).

Concurrency: the ThreadingHTTPServer parses requests and decodes images on
request threads; device work funnels through a :class:`DynamicBatcher` —
one worker thread drains ALL queued images into a single device step
(capped by the largest exported batch size).  While a step is in flight,
arriving requests pile up and ride the next step together, so throughput
under load tracks the batched device step with no artificial coalescing
delay at low load (a lone request still dispatches immediately at batch 1).
The worker is the only thread that launches kernels: it enters
``torch.inference_mode`` itself (``ServingModel.detect``; the mode is
per thread), and the kernels' wrappers launch on the current stream of the
calling thread, which for the worker is the default stream.  A step that
fails fails its own requests (500); nothing retries it on the CPU or
through the kernels' plain versions.
"""

from __future__ import annotations

import argparse
import collections
import io
import json
import math
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

MAX_BODY_BYTES = 64 * 1024 * 1024  # generous for any single medical image
# the most recent step sizes and request latencies /metrics reads
RESERVOIR = 4096


class BadImage(ValueError):
    """The request body could not be decoded as an image (client error)."""


class _Pending:
    __slots__ = ("im", "done", "result", "error")

    def __init__(self, im):
        self.im = im
        self.done = threading.Event()
        self.result = None
        self.error = None


class DynamicBatcher:
    """Coalesce concurrent single-image requests into batched device steps.

    ``backend`` is anything with ``.detect(images) -> [(scores, boxes)...]``
    and ``.batch_sizes`` (a :class:`~wssdl_bus_tpu_torch.serve.
    ServingModel`).
    One daemon worker drains the queue.  The drain size SNAPS to the
    exported batch sizes (``_pick_batch``): padding a big program to serve
    a couple of queued images would be slower than a few small steps, so a
    larger export is used only once the queue fills at least half of it —
    with only batch-1 exported this degrades exactly to serialized batch-1
    dispatch.  A device failure fails exactly the requests in that step.
    """

    #: seconds a request waits on its step before giving up — generous
    #: enough for the first step's kernel build, finite so a wedged worker
    #: cannot strand request threads forever
    STEP_TIMEOUT_S = 1800.0

    def __init__(self, backend):
        self._backend = backend
        self._sizes = sorted(set(backend.batch_sizes))
        self._queue = collections.deque()
        self._cv = threading.Condition()
        self._closed = False
        # recent completed-step batch sizes (bounded) + lifetime counters
        self.step_sizes = collections.deque(maxlen=RESERVOIR)
        self.total_steps = 0
        self.failed_steps = 0
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="wssdl-batcher")
        self._worker.start()

    def _pick_batch(self, qlen: int) -> int:
        """How many requests to drain for a queue of ``qlen``: the smallest
        exported size >= qlen if the queue fills at least half of it
        (bounded padding, one step); otherwise the largest exported size
        <= qlen (no padding, the rest ride the next step)."""
        fits = [s for s in self._sizes if s >= qlen]
        if fits and qlen * 2 >= fits[0]:
            return min(qlen, fits[0])
        under = [s for s in self._sizes if s <= qlen]
        return under[-1] if under else min(qlen, self._sizes[0])

    def detect_one(self, im):
        """Submit one image; blocks until its step completes."""
        p = _Pending(im)
        with self._cv:
            if self._closed:
                raise RuntimeError("batcher is closed")
            self._queue.append(p)
            self._cv.notify()
        if not p.done.wait(timeout=self.STEP_TIMEOUT_S):
            raise RuntimeError(
                f"batched device step did not complete in "
                f"{self.STEP_TIMEOUT_S:.0f}s")
        if p.error is not None:
            # wrap per request: re-raising one shared exception instance
            # from several threads races on its __traceback__
            raise RuntimeError(f"batched step failed: "
                               f"{type(p.error).__name__}: {p.error}") \
                from p.error
        return p.result

    def close(self):
        with self._cv:
            self._closed = True
            self._cv.notify()
        self._worker.join(timeout=5)

    def _run(self):
        while True:
            with self._cv:
                while not self._queue and not self._closed:
                    self._cv.wait()
                if self._closed and not self._queue:
                    return
                n = self._pick_batch(len(self._queue))
                batch = [self._queue.popleft() for _ in range(n)]
            failed = True
            try:
                results = self._backend.detect([p.im for p in batch])
                if len(results) != len(batch):
                    raise RuntimeError(
                        f"backend returned {len(results)} results for "
                        f"{len(batch)} images")
                for p, r in zip(batch, results):
                    p.result = r
                failed = False
            except BaseException as e:  # noqa: BLE001 — forwarded per req
                for p in batch:
                    p.error = e
            finally:
                self.total_steps += 1
                if failed:
                    self.failed_steps += 1
                else:
                    self.step_sizes.append(len(batch))
                for p in batch:
                    p.done.set()


class ServerMetrics:
    """Cheap lock-guarded counters behind ``GET /metrics``.

    Latencies keep a bounded reservoir (the most recent ``RESERVOIR``
    request latencies) so quantiles reflect current behavior and memory
    stays bounded forever."""

    def __init__(self):
        self._lock = threading.Lock()
        self._lat = collections.deque(maxlen=RESERVOIR)
        self.requests = 0
        self.client_errors = 0
        self.server_errors = 0

    def record(self, seconds: float, outcome: str):
        with self._lock:
            self.requests += 1
            if outcome == "client_error":
                self.client_errors += 1
            elif outcome == "server_error":
                self.server_errors += 1
            else:
                self._lat.append(seconds)

    def snapshot(self, batcher) -> dict:
        with self._lock:
            lat = sorted(self._lat)
            out = {
                "requests": self.requests,
                "client_errors": self.client_errors,
                "server_errors": self.server_errors,
                "device_steps": batcher.total_steps,
                "failed_steps": batcher.failed_steps,
                # over the most recent successful steps (bounded window)
                "images_per_step_histogram": dict(
                    collections.Counter(batcher.step_sizes)),
            }
        if lat:
            q = lambda p: round(lat[min(len(lat) - 1,  # noqa: E731
                                        int(p * len(lat)))], 4)
            out["latency_s"] = {"p50": q(0.5), "p90": q(0.9),
                                "p99": q(0.99), "max": round(lat[-1], 4),
                                "n": len(lat)}
        return out


class DetectionService:
    """The request-independent core (constructed once, shared by handlers;
    separable from HTTP for tests)."""

    def __init__(self, artifact_dir: str, device=None):
        from wssdl_bus_tpu_torch.serve import load_serving
        self.served = load_serving(artifact_dir, device=device)
        self.batcher = DynamicBatcher(self.served)
        self.metrics = ServerMetrics()

    def info(self) -> dict:
        m = self.served.meta
        return {"status": "ok", "net_name": m["net_name"],
                "platform": m["platform"],
                "device": str(self.served.device),
                "canvas_hw": m["canvas_hw"],
                "batch_sizes": m["batch_sizes"],
                "quantized": bool(m.get("quantized", False))}

    def detect_bytes(self, payload: bytes, thresh: float = 0.5) -> dict:
        from wssdl_bus_tpu_torch.serve import load_gray, report_detections
        try:
            im = load_gray(io.BytesIO(payload))
        except Exception as e:
            raise BadImage(f"cannot decode image: {e}") from e
        scores, boxes = self.batcher.detect_one(im)
        detections, _ = report_detections(scores, boxes, self.served.cfg,
                                          thresh=thresh)
        return {"image_hw": list(im.shape), "thresh": thresh,
                "detections": detections}


def make_handler(service: DetectionService):
    class Handler(BaseHTTPRequestHandler):
        def _reply(self, code: int, obj: dict):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            path = self.path.split("?")[0]
            if path == "/healthz":
                self._reply(200, service.info())
            elif path == "/metrics":
                self._reply(200, service.metrics.snapshot(service.batcher))
            else:
                self._reply(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            path, _, query = self.path.partition("?")
            if path != "/detect":
                self._reply(404, {"error": f"unknown path {self.path}"})
                return
            thresh = 0.5
            for kv in query.split("&"):
                if kv.startswith("thresh="):
                    try:
                        thresh = float(kv.split("=", 1)[1])
                    except ValueError:
                        thresh = float("nan")
                    if not math.isfinite(thresh):
                        self._reply(400, {"error": "bad thresh"})
                        return
            try:
                n = int(self.headers.get("Content-Length", 0))
            except (TypeError, ValueError):
                self._reply(400, {"error": "bad Content-Length"})
                return
            if n <= 0:
                self._reply(400, {"error": "empty body (send image bytes)"})
                return
            if n > MAX_BODY_BYTES:
                self._reply(413, {"error": f"body exceeds {MAX_BODY_BYTES} "
                                           "bytes"})
                return
            payload = self.rfile.read(n)
            t0 = time.perf_counter()
            try:
                result = service.detect_bytes(payload, thresh)
            except BadImage as e:
                service.metrics.record(time.perf_counter() - t0,
                                       "client_error")
                self._reply(400, {"error": str(e)})
            except Exception as e:
                # anything else (missing program, device failure) is OURS
                service.metrics.record(time.perf_counter() - t0,
                                       "server_error")
                self._reply(500, {"error": f"{type(e).__name__}: {e}"})
            else:
                service.metrics.record(time.perf_counter() - t0, "ok")
                self._reply(200, result)

        def log_message(self, fmt, *a):  # quiet by default
            pass

    return Handler


def serve(artifact_dir: str, host: str = "127.0.0.1", port: int = 8000,
          device=None):
    """The HTTP server over the artifact on ``device`` (CUDA unless named),
    not yet serving: call ``serve_forever`` (``port`` 0 picks a free
    one, ``server_port`` reads it)."""
    service = DetectionService(artifact_dir, device=device)
    httpd = ThreadingHTTPServer((host, port), make_handler(service))
    httpd.service = service  # exposed for tests / embedding
    return httpd


def main(argv=None):
    ap = argparse.ArgumentParser(description="HTTP detection server")
    ap.add_argument("--artifact", required=True, type=str)
    ap.add_argument("--host", default="127.0.0.1", type=str)
    ap.add_argument("--port", default=8000, type=int)
    ap.add_argument("--device", default="cuda", type=str,
                    help="device to serve on: cuda (default) or cpu")
    args = ap.parse_args(argv)
    httpd = serve(args.artifact, args.host, args.port, device=args.device)
    print(f"serving {args.artifact} on {httpd.service.served.device}, "
          f"http://{args.host}:{httpd.server_port}  (POST /detect, GET "
          f"/healthz)")
    httpd.serve_forever()


if __name__ == "__main__":
    main()
