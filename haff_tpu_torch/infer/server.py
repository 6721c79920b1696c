"""Production serving: JSON HTTP API with transparent micro-batching
(port of haff_tpu/infer/server.py).

Concurrent requests are assembled into fixed-shape micro-batches:

  * requests queue up; a dispatch thread collects up to `batch_size` of
    them, waiting at most `max_wait_ms` after the first arrival;
  * a partial batch is padded by repeating its last request (shapes stay
    static, so the evaluate captures ONE decode graph per bucket and
    replays it under bursty load; padded rows are computed and dropped);
  * results fan back out to the waiting connections.

Endpoints:
  GET  /healthz            -> {"ok": true, "pending": N}
  POST /predict            JSON {"image": <base64 png/jpeg>, "prompt": s,
                                 "threshold": 0.5 (optional)}
       -> {"answer": s, "taxonomy": [4 floats],
           "mask_left": <base64 PNG, 0/255>, "mask_right": ...}

Usage: python -m haff_tpu_torch.infer.server [--port 7861] [--batch_size 8]
       [--max_wait_ms 25] [--model_preset 7b] [--load_in_8bit]
       [--device cuda] ...

The JAX server's --compilation_cache (a persistent XLA cache directory)
has no counterpart: the port compiles its kernels once per checkout
(kernels/_build.py) and captures its decode graphs at the warm-up call.
"""

from __future__ import annotations

import argparse
import base64
import collections
import json
import queue
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, List, Sequence

import numpy as np


class _Request:
    __slots__ = ("image", "prompt", "event", "result", "error")

    def __init__(self, image, prompt):
        self.image = image
        self.prompt = prompt
        self.event = threading.Event()
        self.result = None
        self.error = None


class MicroBatcher:
    """Collects concurrent requests into fixed-shape batches.

    predict_batch: (images, prompts) -> list of per-request results.
    """

    def __init__(self, predict_batch: Callable[[Sequence, Sequence], List],
                 batch_size: int = 8, max_wait_ms: float = 25.0):
        assert batch_size >= 1
        self._predict = predict_batch
        self.batch_size = batch_size
        self.max_wait = max_wait_ms / 1e3
        self._q: "queue.Queue[_Request]" = queue.Queue()
        self._stop = threading.Event()
        self._close_lock = threading.Lock()
        self._closed = False
        # recent observed batch sizes (bounded) + lifetime counters
        self.batch_sizes = collections.deque(maxlen=4096)
        self.total_requests = 0
        self.total_batches = 0
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def submit(self, image: np.ndarray, prompt: str):
        """Blocking: enqueue and wait for this request's result."""
        r = _Request(image, prompt)
        with self._close_lock:
            # serialized with close(): no request can slip in between
            # the dispatcher join and the final queue drain
            if self._closed:
                raise RuntimeError("server shutting down")
            self._q.put(r)
        r.event.wait()
        if r.error is not None:
            raise r.error
        return r.result

    def pending(self) -> int:
        return self._q.qsize()

    def close(self):
        with self._close_lock:
            self._closed = True
        self._stop.set()
        self._q.put(None)  # wake the dispatcher
        self._thread.join(timeout=5)
        # fail any requests still queued so submitters don't hang
        while True:
            try:
                r = self._q.get_nowait()
            except queue.Empty:
                break
            if r is not None:
                r.error = RuntimeError("server shutting down")
                r.event.set()

    def _collect(self) -> List[_Request]:
        try:
            first = self._q.get(timeout=0.1)
        except queue.Empty:
            return []
        if first is None:
            return []
        batch = [first]
        deadline = _now() + self.max_wait
        while len(batch) < self.batch_size:
            timeout = deadline - _now()
            if timeout <= 0:
                break
            try:
                nxt = self._q.get(timeout=timeout)
            except queue.Empty:
                break
            if nxt is None:
                break
            batch.append(nxt)
        return batch

    def _loop(self):
        while not self._stop.is_set():
            batch = self._collect()
            if not batch:
                continue
            self.batch_sizes.append(len(batch))
            self.total_batches += 1
            self.total_requests += len(batch)
            # pad to the bucket size by repeating the last request:
            # static shapes -> one compiled executable per bucket.
            pad = self.batch_size - len(batch)
            images = [r.image for r in batch] + [batch[-1].image] * pad
            prompts = [r.prompt for r in batch] + [batch[-1].prompt] * pad
            try:
                results = self._predict(images, prompts)
                for r, res in zip(batch, results):
                    r.result = res
                    r.event.set()
            except Exception as e:  # fan the failure out, keep serving
                for r in batch:
                    r.error = e
                    r.event.set()


def _now() -> float:
    import time

    return time.monotonic()


def _png_b64(binary: np.ndarray) -> str:
    import cv2

    ok, buf = cv2.imencode(".png", (binary * 255).astype(np.uint8))
    assert ok
    return base64.b64encode(buf.tobytes()).decode()


def make_handler(batcher: MicroBatcher):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _json(self, code: int, obj: dict):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path.startswith("/healthz"):
                self._json(200, {"ok": True, "pending": batcher.pending()})
            else:
                self._json(404, {"error": "not found"})

        def do_POST(self):
            import cv2

            if not self.path.startswith("/predict"):
                self._json(404, {"error": "not found"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(length))
                raw = base64.b64decode(req["image"])
                arr = np.frombuffer(raw, np.uint8)
                bgr = cv2.imdecode(arr, cv2.IMREAD_COLOR)
                if bgr is None:
                    raise ValueError("undecodable image")
                image = bgr[:, :, ::-1]  # RGB
                prompt = req["prompt"]
                threshold = float(req.get("threshold", 0.5))
            except Exception as e:
                self._json(400, {"error": f"bad request: {e}"})
                return
            try:
                text, ml, mr, tax = batcher.submit(image, prompt)
            except Exception as e:
                self._json(500, {"error": str(e)})
                return
            # sigmoid-then-threshold on the mask LOGITS + taxonomy
            # gating (blank the inactive hand when the taxonomy says
            # one-handed) — same protocol as app/chat/CLI (reference
            # inference.py:278-313).
            bl = (1.0 / (1.0 + np.exp(-ml)) > threshold).astype(np.uint8)
            br = (1.0 / (1.0 + np.exp(-mr)) > threshold).astype(np.uint8)
            t = int(np.argmax(np.asarray(tax)))
            if t == 0:
                br[:] = 0
            elif t == 1:
                bl[:] = 0
            self._json(200, {
                "answer": text,
                "taxonomy": [float(x) for x in np.asarray(tax)],
                "mask_left": _png_b64(bl),
                "mask_right": _png_b64(br),
            })

    return Handler


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--port", type=int, default=7861)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--max_wait_ms", type=float, default=25.0)
    p.add_argument("--model_preset", default="7b")
    p.add_argument("--decoder", default="llama")
    p.add_argument("--checkpoint", default=None,
                   help="export_params .npz (seeded random init if absent)")
    p.add_argument("--tokenizer", default=None)
    p.add_argument("--precision", default="bf16")
    p.add_argument("--max_new_tokens", type=int, default=32)
    p.add_argument("--load_in_8bit", action="store_true")
    p.add_argument("--load_in_4bit", action="store_true")
    p.add_argument("--kv_cache_8bit", action="store_true")
    p.add_argument("--speculative", action="store_true",
                   help="prompt-lookup speculative decoding (not ported "
                        "yet: raises)")
    p.add_argument("--draft_len", type=int, default=8)
    p.add_argument("--device", default="cuda",
                   help="cuda (the card) or cpu")
    args = p.parse_args(argv)

    from .predictor import Predictor

    predictor = Predictor(
        model_preset=args.model_preset, decoder=args.decoder,
        checkpoint=args.checkpoint, tokenizer=args.tokenizer,
        precision=args.precision, max_new_tokens=args.max_new_tokens,
        load_in_8bit=args.load_in_8bit, load_in_4bit=args.load_in_4bit,
        kv_cache_8bit=args.kv_cache_8bit,
        speculative=args.speculative, draft_len=args.draft_len,
        device=args.device)
    # warm the bucket so the first burst doesn't pay the graph capture
    dummy = np.zeros((64, 64, 3), np.uint8)
    predictor.predict_batch([dummy] * args.batch_size,
                            ["warmup"] * args.batch_size)
    batcher = MicroBatcher(predictor.predict_batch,
                           batch_size=args.batch_size,
                           max_wait_ms=args.max_wait_ms)
    srv = ThreadingHTTPServer(("0.0.0.0", args.port), make_handler(batcher))
    print(f"serving on :{args.port} (batch {args.batch_size}, "
          f"wait {args.max_wait_ms} ms)")
    try:
        srv.serve_forever()
    finally:
        batcher.close()


if __name__ == "__main__":
    main()
