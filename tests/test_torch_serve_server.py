"""The port's HTTP detection server (``wssdl_bus_tpu_torch/serve/
server.py``): the JAX package's pure-host batcher tests
(``tests/test_serve_server.py``) on the port's ``DynamicBatcher``, and its
HTTP tests on a small ResNet-18 BN CPU artifact (64x96 canvas, RPN 50 ->
10; the JAX package marks those slow for its export compile, and a port
artifact has none): health, ``/detect`` equal to the library path, bad
requests, 413, 500 on an injected fault, concurrent requests (coalesced
into the exported batch sizes 1 and 4) and metrics."""

import http.client
import io
import json
import threading
import time

import numpy as np
import pytest
import torch
from PIL import Image

from wssdl_bus_tpu_torch.config import Config
from wssdl_bus_tpu_torch.evaluate.detect import im_detect
from wssdl_bus_tpu_torch.models.convert import he_init_
from wssdl_bus_tpu_torch.models.detector import build_detector
from wssdl_bus_tpu_torch.serve import export_serving, report_detections
from wssdl_bus_tpu_torch.serve.server import DynamicBatcher, serve
from wssdl_bus_tpu_torch.train.engine import Engine

CANVAS = (64, 96)
NET = "Resnet_test"


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    torch.set_num_threads(2)
    cfg = Config().with_overrides([
        "TEST.SCALES", "(64,)", "TEST.MAX_SIZE", "96",
        "TEST.RPN_PRE_NMS_TOP_N", "50", "TEST.RPN_POST_NMS_TOP_N", "10"])
    model = he_init_(build_detector(NET, device="cpu", depth=18, norm="BN"),
                     0)
    eng = Engine(model, cfg, CANVAS, device="cpu")
    art = str(tmp_path_factory.mktemp("srv_artifact"))
    export_serving(eng, art, NET, batch_sizes=(1, 4))

    httpd = serve(art, host="127.0.0.1", port=0, device="cpu")
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield httpd, eng
    httpd.shutdown()
    httpd.server_close()
    httpd.service.batcher.close()
    t.join(timeout=30)
    assert not t.is_alive()


def _png_bytes(im: np.ndarray) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(im).save(buf, format="PNG")
    return buf.getvalue()


def _request(httpd, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", httpd.server_port,
                                      timeout=120)
    conn.request(method, path, body=body)
    r = conn.getresponse()
    out = (r.status, json.loads(r.read().decode()))
    conn.close()
    return out


def _library(eng, im, thresh):
    """``report_detections`` of the live engine's single-image path, as
    the server's JSON would carry it."""
    scores, boxes = im_detect(eng, im, NET, CANVAS)
    want, _ = report_detections(scores, boxes, eng.cfg, thresh=thresh)
    return json.loads(json.dumps(want))


def _speckle(seed, h=60, w=80):
    rng = np.random.RandomState(seed)
    im = rng.randint(60, 140, (h, w)).astype(np.uint8)
    im[h // 4:h // 2, w // 4:3 * w // 4] = 220
    return im


def test_healthz(server):
    httpd, _ = server
    code, obj = _request(httpd, "GET", "/healthz")
    assert code == 200
    assert obj["status"] == "ok"
    assert obj["batch_sizes"] == [1, 4]
    assert obj["canvas_hw"] == list(CANVAS)
    assert (obj["platform"], obj["device"]) == ("cpu", "cpu")
    assert obj["quantized"] is False


def test_detect_matches_library_path(server):
    httpd, eng = server
    im = np.full((100, 120), 128, np.uint8)
    im[30:60, 40:90] = 200
    code, obj = _request(httpd, "POST", "/detect?thresh=0.0",
                         body=_png_bytes(im))
    assert code == 200
    assert obj["image_hw"] == [100, 120]
    assert obj["detections"] == _library(eng, im, 0.0)
    assert obj["detections"], "nothing reported at thresh 0"


def test_bad_requests(server):
    httpd, _ = server
    code, obj = _request(httpd, "GET", "/nope")
    assert code == 404
    code, obj = _request(httpd, "POST", "/detect")
    assert code == 400 and "empty" in obj["error"]
    code, obj = _request(httpd, "POST", "/detect", body=b"not an image")
    assert code == 400 and "decode" in obj["error"]
    code, obj = _request(httpd, "POST", "/detect?thresh=abc", body=b"x")
    assert code == 400
    code, obj = _request(httpd, "POST", "/detect?thresh=nan", body=b"x")
    assert code == 400
    code, obj = _request(httpd, "POST", "/detect?thresh=inf", body=b"x")
    assert code == 400


def test_oversized_body_rejected(server, monkeypatch):
    import wssdl_bus_tpu_torch.serve.server as srv
    httpd, _ = server
    monkeypatch.setattr(srv, "MAX_BODY_BYTES", 16)
    code, obj = _request(httpd, "POST", "/detect", body=b"x" * 17)
    assert code == 413


def test_internal_fault_is_500(server, monkeypatch):
    """A failing device step answers 500 with its error, and nothing
    retries it elsewhere: the step was called once."""
    httpd, _ = server
    im = np.full((40, 40), 128, np.uint8)
    calls = []

    def boom(images):
        calls.append(len(images))
        raise RuntimeError("device fell over")
    monkeypatch.setattr(httpd.service.served, "detect", boom)
    code, obj = _request(httpd, "POST", "/detect", body=_png_bytes(im))
    assert code == 500 and "device fell over" in obj["error"]
    assert calls == [1]


def test_concurrent_requests_all_served(server):
    """Concurrent POSTs of distinct images all return 200, each with its
    own image's detections: the classes of the library path, scores and
    boxes within f32 drift (a coalesced step runs at batch 4, where
    oneDNN may pick another convolution algorithm)."""
    httpd, eng = server
    ims = [_speckle(i) for i in range(8)]
    outs = {}

    def hit(i):
        outs[i] = _request(httpd, "POST", "/detect?thresh=0.0",
                           body=_png_bytes(ims[i]))

    threads = [threading.Thread(target=hit, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    assert sorted(outs) == list(range(8))
    for i, (code, obj) in outs.items():
        assert code == 200
        assert obj["image_hw"] == [60, 80]
        want = _library(eng, ims[i], 0.0)
        got = obj["detections"]
        assert sorted(d["class"] for d in got) == \
            sorted(d["class"] for d in want)
        # a report is ordered by score, and drift may reorder near-ties:
        # pair each entry with the nearest box of its class, one to one
        for cls in {d["class"] for d in want}:
            g = [d for d in got if d["class"] == cls]
            w = [d for d in want if d["class"] == cls]
            dist = np.abs(np.array([d["box"] for d in g])[:, None]
                          - np.array([d["box"] for d in w])[None]).max(-1)
            pair = dist.argmin(1)
            assert len(set(pair.tolist())) == len(g)
            assert dist[np.arange(len(g)), pair].max() <= 1e-3
            np.testing.assert_allclose([d["score"] for d in g],
                                       [w[j]["score"] for j in pair],
                                       rtol=0, atol=1e-5)


def test_metrics_endpoint(server):
    httpd, _ = server
    im = np.full((50, 50), 90, np.uint8)
    code, _ = _request(httpd, "POST", "/detect", body=_png_bytes(im))
    assert code == 200
    code, _ = _request(httpd, "POST", "/detect", body=b"not an image")
    assert code == 400
    code, m = _request(httpd, "GET", "/metrics")
    assert code == 200
    assert m["requests"] >= 2
    assert m["client_errors"] >= 1
    assert m["device_steps"] >= 1
    assert sum(int(k) * v for k, v in
               m["images_per_step_histogram"].items()) >= 1
    assert set(m["images_per_step_histogram"]) <= {"1", "2", "3", "4"}
    assert m["latency_s"]["p50"] > 0
    assert m["latency_s"]["max"] >= m["latency_s"]["p90"] \
        >= m["latency_s"]["p50"]


# ------------------------------------------------------------------ #
# DynamicBatcher: request coalescing (the JAX package's host tests)
# ------------------------------------------------------------------ #
def test_dynamic_batcher_coalesces():
    """While a step is in flight, queued requests ride the NEXT step
    together (capped by the largest exported batch size) — deterministic via a gated backend."""
    release = threading.Event()
    first_entered = threading.Event()

    class Fake:
        batch_sizes = [1, 4]

        def detect(self, images):
            if not first_entered.is_set():
                first_entered.set()
                release.wait(timeout=30)
            return [("r", int(im)) for im in images]

    b = DynamicBatcher(Fake())
    results = {}

    def submit(i):
        results[i] = b.detect_one(i)

    threads = [threading.Thread(target=submit, args=(i,)) for i in range(8)]
    threads[0].start()
    assert first_entered.wait(timeout=30)  # worker is inside step 1
    for t in threads[1:]:
        t.start()
    # wait until the remaining 7 are queued, then release the gate
    for _ in range(3000):
        with b._cv:
            if len(b._queue) == 7:
                break
        time.sleep(0.01)
    release.set()
    for t in threads:
        t.join(timeout=30)
    b.close()
    assert results == {i: ("r", i) for i in range(8)}
    assert b.step_sizes[0] == 1          # the lone first request
    assert max(b.step_sizes) <= 4        # capped by the exported batch
    assert sorted(list(b.step_sizes)[1:]) == [3, 4]  # 7 queued -> 4 + 3


def test_dynamic_batcher_step_failure_is_scoped():
    """A device failure fails exactly the requests in that step; the
    batcher keeps serving afterwards."""
    class Flaky:
        batch_sizes = [2]
        calls = 0

        def detect(self, images):
            Flaky.calls += 1
            if Flaky.calls == 1:
                raise RuntimeError("transient")
            return [("ok", int(im)) for im in images]

    b = DynamicBatcher(Flaky())
    with pytest.raises(RuntimeError, match="transient"):
        b.detect_one(0)
    assert b.detect_one(1) == ("ok", 1)
    b.close()


def test_pick_batch_snaps_to_exported_sizes():
    """Low queue depth must NOT pad up to a big exported program: snap up
    only when the queue fills at least half of the next export."""
    class Fake:
        batch_sizes = [1, 8, 32]

        def detect(self, images):
            return [None] * len(images)

    b = DynamicBatcher(Fake())
    try:
        assert b._pick_batch(1) == 1      # lone request: batch-1 program
        assert b._pick_batch(2) == 1      # 2 < 8/2: don't pad to 8
        assert b._pick_batch(4) == 4      # 4 >= 8/2: one padded batch-8
        assert b._pick_batch(8) == 8
        assert b._pick_batch(12) == 8     # 12 < 32/2: drain 8, rest next
        assert b._pick_batch(16) == 16    # >= 32/2: one padded batch-32
        assert b._pick_batch(100) == 32   # capped at the largest export
    finally:
        b.close()


def test_batcher_failed_steps_not_in_histogram():
    class Flaky2:
        batch_sizes = [1]
        calls = 0

        def detect(self, images):
            Flaky2.calls += 1
            if Flaky2.calls == 1:
                raise RuntimeError("boom")
            return [("ok", int(im)) for im in images]

    b = DynamicBatcher(Flaky2())
    with pytest.raises(RuntimeError, match="boom"):
        b.detect_one(0)
    assert b.detect_one(5) == ("ok", 5)
    b.close()
    assert b.failed_steps == 1
    assert b.total_steps == 2
    assert list(b.step_sizes) == [1]


def test_batcher_result_count_mismatch_is_error():
    class Short:
        batch_sizes = [1]

        def detect(self, images):
            return []  # one result too few

    b = DynamicBatcher(Short())
    with pytest.raises(RuntimeError, match="0 results for 1"):
        b.detect_one(1)
    b.close()


def test_server_needs_a_card_unless_told(server, monkeypatch):
    """``serve`` / ``DetectionService`` without ``device`` want CUDA."""
    from wssdl_bus_tpu_torch.serve.server import DetectionService

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DetectionService(server[0].service.served.path)
