"""Web demo (port of haff_tpu/infer/app.py, the reference 2Haff/app.py
analog). Gradio is not in this image; a dependency-free stdlib HTTP
server gives the same capability: a browser form with image upload and
prompt, and a red/blue bimanual overlay as the response, through the
dual-decoder evaluate path.

Usage: python -m haff_tpu_torch.infer.app [--port 7860] [--model_preset 7b]
       [--device cuda|cpu] ...
"""

from __future__ import annotations

import argparse
import json
from http.server import BaseHTTPRequestHandler, HTTPServer

import numpy as np

PAGE = b"""<!doctype html>
<title>2HandedAfforder demo</title>
<h2>Bimanual affordance demo</h2>
<form method=post enctype=multipart/form-data action=/predict>
  Prompt: <input name=prompt size=60
    value="Where would you interact with the object to perform action open drawer">
  <br><br>Image: <input type=file name=image accept=image/*>
  <br><br><input type=submit value=Segment>
</form>
"""


def make_handler(predictor, threshold: float):
    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            self.send_response(200)
            self.send_header("Content-Type", "text/html")
            self.end_headers()
            self.wfile.write(PAGE)

        def do_POST(self):
            import cv2

            from ..eval.tools import overlay_results

            length = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(length)
            ctype = self.headers.get("Content-Type", "")
            boundary = ctype.split("boundary=")[-1].encode()
            prompt, img_bytes = "", None
            for part in body.split(b"--" + boundary):
                if b'name="prompt"' in part:
                    prompt = part.split(b"\r\n\r\n", 1)[1].rstrip(
                        b"\r\n-").decode(errors="replace")
                elif b'name="image"' in part and b"\r\n\r\n" in part:
                    img_bytes = part.split(b"\r\n\r\n", 1)[1].rstrip(
                        b"\r\n-")
            if not img_bytes:
                self.send_error(400, "no image")
                return
            arr = np.frombuffer(img_bytes, np.uint8)
            bgr = cv2.imdecode(arr, cv2.IMREAD_COLOR)
            image = cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)

            text, ml, mr, tax = predictor(image, prompt)
            probs_l = 1 / (1 + np.exp(-ml))
            probs_r = 1 / (1 + np.exp(-mr))
            bl = (probs_l > threshold).astype(np.uint8)
            br = (probs_r > threshold).astype(np.uint8)
            t = int(np.argmax(tax))
            if t == 0:
                br[:] = 0
            elif t == 1:
                bl[:] = 0
            overlay = overlay_results(image, bl, br)
            ok, png = cv2.imencode(
                ".png", cv2.cvtColor(overlay, cv2.COLOR_RGB2BGR))
            self.send_response(200)
            self.send_header("Content-Type", "image/png")
            self.send_header("X-Model-Text", json.dumps(text)[:512])
            self.send_header("X-Taxonomy",
                             json.dumps(tax.round(3).tolist()))
            self.end_headers()
            self.wfile.write(png.tobytes())

        def log_message(self, fmt, *a):
            print("[app]", fmt % a)

    return Handler


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--port", type=int, default=7860)
    p.add_argument("--model_preset", default="7b")
    p.add_argument("--decoder", default="llama", choices=["llama", "mpt"])
    p.add_argument("--checkpoint", default=None,
                   help="export_params .npz (seeded random init if absent)")
    p.add_argument("--tokenizer", default=None)
    p.add_argument("--load_in_8bit", action="store_true")
    p.add_argument("--load_in_4bit", action="store_true")
    p.add_argument("--conv_type", default="llava_v1",
                   choices=["llava_v1", "llava_llama_2"])
    p.add_argument("--use_mm_start_end", action="store_true", default=True)
    p.add_argument("--no_mm_start_end", dest="use_mm_start_end",
                   action="store_false")
    p.add_argument("--kv_cache_8bit", action="store_true")
    p.add_argument("--speculative", action="store_true",
                   help="prompt-lookup speculative decoding (ANSWER_LIST "
                        "template drafts; exact greedy output, fewer decode "
                        "forwards; llama decoder only)")
    p.add_argument("--draft_len", type=int, default=8,
                   help="tokens a speculative verify step (>= 2)")
    p.add_argument("--threshold", type=float, default=0.5)
    p.add_argument("--device", default="cuda",
                   help="cuda (the card) or cpu")
    args = p.parse_args(argv)

    from .predictor import Predictor

    predictor = Predictor(model_preset=args.model_preset,
                          decoder=args.decoder,
                          checkpoint=args.checkpoint,
                          tokenizer=args.tokenizer,
                          load_in_8bit=args.load_in_8bit,
                          load_in_4bit=args.load_in_4bit,
                          kv_cache_8bit=args.kv_cache_8bit,
                          speculative=args.speculative,
                          draft_len=args.draft_len,
                          device=args.device,
                          conv_type=args.conv_type,
                          use_mm_start_end=args.use_mm_start_end)
    server = HTTPServer(("0.0.0.0", args.port),
                        make_handler(predictor, args.threshold))
    print(f"demo on http://0.0.0.0:{args.port}")
    server.serve_forever()


if __name__ == "__main__":
    main()
