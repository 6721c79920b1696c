"""The port's micro-batching server (haff_tpu_torch/infer/server.py): the
MicroBatcher cases of tests/test_server.py against the port's module
(coalescing, padding of partial batches, errors, submit after close, the
HTTP round trip), and one HTTP answer of a tiny port Predictor on the CPU
against the JAX server's answer from the same weights."""

import base64
import json
import threading
import time
import urllib.request
from http.server import ThreadingHTTPServer

import cv2
import numpy as np
import pytest

from haff_tpu.infer import server as jserver
from haff_tpu.infer.predictor import Predictor as JaxPredictor
from haff_tpu_torch.infer.predictor import Predictor
from haff_tpu_torch.infer.server import MicroBatcher, make_handler
from test_torch_bridge import write_npz


def fake_predict(images, prompts):
    # echoes per-request identity; slow enough that concurrent
    # submissions coalesce into one batch
    time.sleep(0.05)
    out = []
    for img, p in zip(images, prompts):
        ml = np.full(img.shape[:2], float(img[0, 0, 0]) / 255.0)
        out.append((f"ans:{p}", ml, ml * 0.5, np.array([1, 0, 0, 0.0])))
    return out


def test_submit_after_close_raises():
    b = MicroBatcher(fake_predict, batch_size=2, max_wait_ms=5)
    b.close()
    with pytest.raises(RuntimeError, match="shutting down"):
        b.submit(np.zeros((4, 4, 3), np.uint8), "late")


def test_microbatcher_coalesces_and_fans_out():
    b = MicroBatcher(fake_predict, batch_size=4, max_wait_ms=80)
    results = {}

    def worker(i):
        img = np.full((8, 8, 3), i * 10, np.uint8)
        results[i] = b.submit(img, f"p{i}")

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    b.close()
    for i in range(6):
        text, ml, mr, tax = results[i]
        assert text == f"ans:p{i}"
        assert ml.shape == (8, 8)
        np.testing.assert_allclose(ml[0, 0], i * 10 / 255.0)
    assert sum(b.batch_sizes) == 6
    assert len(b.batch_sizes) <= 3, b.batch_sizes
    assert max(b.batch_sizes) >= 2
    assert b.total_requests == 6 and b.total_batches == len(b.batch_sizes)


def test_microbatcher_pads_partial_batches():
    seen = []

    def spy(images, prompts):
        seen.append((len(images), prompts))
        return fake_predict(images, prompts)

    b = MicroBatcher(spy, batch_size=4, max_wait_ms=5)
    assert b.submit(np.zeros((4, 4, 3), np.uint8), "solo")[0] == "ans:solo"
    b.close()
    # padded up to the bucket size by repeating the last request
    assert seen == [(4, ["solo"] * 4)]


def test_microbatcher_propagates_errors():
    def boom(images, prompts):
        raise RuntimeError("backend down")

    b = MicroBatcher(boom, batch_size=2, max_wait_ms=5)
    with pytest.raises(RuntimeError, match="backend down"):
        b.submit(np.zeros((4, 4, 3), np.uint8), "x")
    b.close()


def _serve(batcher, handler):
    srv = ThreadingHTTPServer(("127.0.0.1", 0), handler(batcher))
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}"


def _post(url, image, prompt, **extra):
    ok, buf = cv2.imencode(".png", image[:, :, ::-1])
    assert ok
    payload = json.dumps({"image": base64.b64encode(buf.tobytes()).decode(),
                          "prompt": prompt, **extra}).encode()
    req = urllib.request.Request(f"{url}/predict", data=payload,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def _mask(b64):
    return cv2.imdecode(np.frombuffer(base64.b64decode(b64), np.uint8),
                        cv2.IMREAD_GRAYSCALE)


def test_http_roundtrip():
    b = MicroBatcher(fake_predict, batch_size=2, max_wait_ms=5)
    srv, url = _serve(b, make_handler)
    try:
        with urllib.request.urlopen(f"{url}/healthz", timeout=10) as r:
            assert json.loads(r.read()) == {"ok": True, "pending": 0}
        out = _post(url, np.full((10, 12, 3), 200, np.uint8),
                    "open the drawer")
        assert out["answer"] == "ans:open the drawer"
        assert len(out["taxonomy"]) == 4
        # logits 200/255 -> sigmoid 0.687 > 0.5 everywhere
        assert _mask(out["mask_left"]).shape == (10, 12)
        assert (_mask(out["mask_left"]) == 255).all()
        # taxonomy [1,0,0,0] = left-only: the right mask is gated off
        assert (_mask(out["mask_right"]) == 0).all()
        bad = urllib.request.Request(
            f"{url}/predict", data=b"{}",
            headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(bad, timeout=10)
        assert ei.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(f"{url}/nowhere", timeout=10)
        assert ei.value.code == 404
    finally:
        srv.shutdown()
        b.close()


def test_http_answer_of_a_tiny_predictor_matches_jax(tmp_path):
    kw = dict(model_preset="tiny", precision="fp32", max_new_tokens=4,
              max_text_len=448)
    jax_pred = JaxPredictor(**kw)
    port_pred = Predictor(**kw, device="cpu",
                          checkpoint=write_npz(jax_pred.params,
                                               tmp_path / "p.npz"))
    image = (np.random.RandomState(3).rand(40, 52, 3) * 255).astype(np.uint8)
    answers = []
    for mod, pred in ((jserver, jax_pred), (None, port_pred)):
        b = (mod.MicroBatcher if mod else MicroBatcher)(
            pred.predict_batch, batch_size=1, max_wait_ms=5)
        srv, url = _serve(b, mod.make_handler if mod else make_handler)
        try:
            answers.append(_post(url, image, "open the drawer",
                                 threshold=0.4))
        finally:
            srv.shutdown()
            b.close()
    ref, got = answers
    assert got["answer"] == ref["answer"]
    np.testing.assert_allclose(got["taxonomy"], ref["taxonomy"], rtol=1e-4,
                               atol=1e-4)
    _, ml, mr, tax = port_pred(image, "open the drawer")
    th_logit = np.log(0.4 / 0.6)
    for key, logits in (("mask_left", ml), ("mask_right", mr)):
        g, r = _mask(got[key]), _mask(ref[key])
        assert g.shape == r.shape == (40, 52)
        # The masks agree but where a logit lies within 1e-3 of the
        # threshold's (the logits agree within 1e-4).
        near = np.abs(logits - th_logit) < 1e-3
        assert ((g != r) & ~near).sum() == 0, key
