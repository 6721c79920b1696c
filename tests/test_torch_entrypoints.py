"""The port's entry points on the CPU at the tiny preset: the batch CLI
(haff_tpu_torch/infer/cli.py) against haff_tpu's on a benchmark folder
the test writes, with the JAX CLI's own initial weights carried over
through an export .npz; the robot demo's poll, the chat REPL and the web
demo on a port Predictor; `overlay_results` against haff_tpu's; and the
entry points' refusal to fall back to the CPU when no device is named.
Image IO is cv2's in both packages."""

import json
import os
import threading
import urllib.request
from http.server import HTTPServer

import cv2
import numpy as np
import pytest
import torch

import haff_tpu.infer.evaluate as jax_evaluate
import haff_tpu_torch.infer.predictor as pred_mod
from haff_tpu.eval.tools import overlay_results as jax_overlay
from haff_tpu.infer import cli as jax_cli
from haff_tpu_torch.eval.tools import overlay_results
from haff_tpu_torch.infer import app, chat, cli, robot_demo, server
from haff_tpu_torch.infer.predictor import Predictor
from test_torch_bridge import write_npz

TINY = ["--model_preset", "tiny", "--precision", "fp32", "--batch", "2",
        "--max_new_tokens", "4", "--max_text_len", "160"]


@pytest.fixture(scope="module")
def predictor():
    return Predictor(model_preset="tiny", precision="fp32", max_new_tokens=4,
                     max_text_len=448, device="cpu")


def _benchmark(root):
    """Two frames of one video, 2HANDS benchmark layout."""
    rng = np.random.RandomState(0)
    for i, (hw, narration) in enumerate((((50, 70), "Open Drawer"),
                                         ((64, 48), "cut onion"))):
        fdir = os.path.join(root, "vid1", f"{i:07d}")
        os.makedirs(fdir)
        img = (rng.rand(*hw, 3) * 255).astype(np.uint8)
        cv2.imwrite(os.path.join(fdir, "inpainting.png"), img)
        with open(os.path.join(fdir, "annotation.json"), "w") as f:
            json.dump({"narration": narration, "taxonomy": [0, 0, 1, 0]}, f)


def _written(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            out[os.path.relpath(os.path.join(d, f), root)] = cv2.imread(
                os.path.join(d, f), cv2.IMREAD_UNCHANGED)
    return out


def test_cli_matches_jax(tmp_path, monkeypatch):
    bench = str(tmp_path / "bench")
    _benchmark(bench)
    # The JAX CLI initialises from PRNGKey(0); its evaluate sees those
    # weights first, so a wrapper keeps them for the port's --checkpoint.
    seen = {}
    real = jax_evaluate.make_jitted_evaluate

    def keep_params(*a, **kw):
        ev = real(*a, **kw)

        def run(params, *args):
            seen.setdefault("params", params)
            return ev(params, *args)
        return run

    monkeypatch.setattr(jax_evaluate, "make_jitted_evaluate", keep_params)
    jax_cli.main(["--benchmark_dir", bench, "--vis_save_path",
                  str(tmp_path / "jax" / "vis"), *TINY])
    npz = write_npz(seen["params"], tmp_path / "p.npz")
    cli.main(["--benchmark_dir", bench, "--vis_save_path",
              str(tmp_path / "port" / "vis"), *TINY, "--checkpoint", npz,
              "--device", "cpu"])
    ref, got = _written(tmp_path / "jax"), _written(tmp_path / "port")
    # Every threshold directory, the same taxonomy-gated files.
    assert set(got) == set(ref) and len(ref) >= 10
    for name, r in ref.items():
        assert got[name].shape == r.shape, name
        assert set(np.unique(got[name])) <= {0, 255}
        np.testing.assert_array_equal(got[name], r, err_msg=name)


def test_write_threshold_masks_gates_by_taxonomy(tmp_path):
    logits = np.linspace(-3, 3, 24, dtype=np.float32).reshape(4, 6)
    for tax, files in ((0, {"aff_left.png"}), (1, {"aff_right.png"}),
                       (2, {"aff_left.png", "aff_right.png"})):
        base = str(tmp_path / f"t{tax}" / "vis")
        cli.write_threshold_masks(base, "v", "f", logits, -logits,
                                  np.eye(4)[tax], [0.5])
        assert set(os.listdir(base + "0.5/v/f")) == files
    m = cv2.imread(str(tmp_path / "t2" / "vis0.5" / "v" / "f" /
                       "aff_left.png"), cv2.IMREAD_GRAYSCALE)
    np.testing.assert_array_equal(m, (logits > 0) * 255)


def test_robot_demo_poll(predictor, tmp_path):
    """Reference protocol: comma margins, required object mask, heatmaps,
    force-gated outputs, object masks kept after processing."""
    root = str(tmp_path / "robot")
    os.makedirs(os.path.join(root, "in"))
    img = (np.random.RandomState(1).rand(50, 70, 3) * 255).astype(np.uint8)
    cv2.imwrite(os.path.join(root, "in", "img.png"), img)
    with open(os.path.join(root, "in", "prompt.txt"), "w") as f:
        f.write("grab the cup")
    # no margins yet -> not processed
    assert not robot_demo.process_once(predictor, root, th=-5.0, force="both")
    with open(os.path.join(root, "in", "margins.txt"), "w") as f:
        f.write("5,3,2,4")          # left,top,right,bottom
    # no object masks yet -> not processed
    assert not robot_demo.process_once(predictor, root, th=-5.0, force="both")
    obj = np.zeros((57, 77), np.uint8)   # pre-crop frame size
    obj[10:40, 10:60] = 255
    cv2.imwrite(os.path.join(root, "in", "mask_left.png"), obj)

    assert robot_demo.process_once(predictor, root, th=-5.0, force="both")
    out = os.path.join(root, "out")
    for name in ("aff_left.png", "aff_right.png", "aff_left_heat.png",
                 "aff_right_heat.png", "cropped_img.png", "text.txt"):
        assert os.path.exists(os.path.join(out, name)), name
    m = cv2.imread(os.path.join(out, "aff_left.png"), 0)
    assert m.shape == (57, 77)       # re-padded to the pre-crop size
    assert m[obj == 0].max() == 0    # AND with the object mask
    # the frame comes back as it was read
    np.testing.assert_array_equal(
        cv2.imread(os.path.join(out, "cropped_img.png")), img)
    assert not os.path.exists(os.path.join(root, "in", "img.png"))
    assert os.path.exists(os.path.join(root, "in", "mask_left.png"))
    assert not robot_demo.process_once(predictor, root, th=-5.0, force="both")


def test_chat_saves_masks_and_overlay(predictor, tmp_path, monkeypatch):
    img = (np.random.RandomState(2).rand(30, 40, 3) * 255).astype(np.uint8)
    path = str(tmp_path / "frame.png")
    cv2.imwrite(path, img[:, :, ::-1])
    answers = iter(["open the drawer", path, ""])
    monkeypatch.setattr("builtins.input", lambda *_: next(answers))
    # chat.main builds its Predictor from the flags; hand it the fixture's.
    monkeypatch.setattr(pred_mod, "Predictor", lambda **kw: predictor)
    out = tmp_path / "vis"
    chat.main(["--model_preset", "tiny", "--vis_save_path", str(out),
               "--device", "cpu"])
    assert sorted(os.listdir(out)) == ["frame_mask_left0.jpg",
                                       "frame_mask_right0.jpg",
                                       "frame_masked_img.png"]
    assert cv2.imread(str(out / "frame_masked_img.png")).shape == (30, 40, 3)


def test_app_answers_a_multipart_post(predictor):
    srv = HTTPServer(("127.0.0.1", 0), app.make_handler(predictor, 0.5))
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            assert b"<form" in r.read()
        img = (np.random.RandomState(4).rand(20, 26, 3) * 255).astype(np.uint8)
        ok, png = cv2.imencode(".png", img)
        body = (b"--XB\r\nContent-Disposition: form-data; name=\"prompt\""
                b"\r\n\r\nopen it\r\n--XB\r\nContent-Disposition: form-data;"
                b" name=\"image\"; filename=\"a.png\"\r\n\r\n" + png.tobytes()
                + b"\r\n--XB--\r\n")
        req = urllib.request.Request(
            f"{url}/predict", data=body, headers={
                "Content-Type": "multipart/form-data; boundary=XB"})
        with urllib.request.urlopen(req, timeout=60) as r:
            tax = json.loads(r.headers["X-Taxonomy"])
            overlay = cv2.imdecode(np.frombuffer(r.read(), np.uint8),
                                   cv2.IMREAD_COLOR)
        assert overlay.shape == (20, 26, 3) and len(tax) == 4
    finally:
        srv.shutdown()


def test_overlay_results_equal():
    rng = np.random.RandomState(5)
    img = (rng.rand(16, 20, 3) * 255).astype(np.uint8)
    ml, mr = rng.rand(16, 20) > 0.5, rng.rand(16, 20) > 0.7
    for args in ((ml, mr), (ml, None), (None, mr), (None, None)):
        np.testing.assert_array_equal(overlay_results(img, *args, alpha=0.3),
                                      jax_overlay(img, *args, alpha=0.3))


def test_entry_points_do_not_fall_back_to_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the defaults run there")
    bench = str(tmp_path / "bench")
    _benchmark(bench)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Predictor(model_preset="tiny")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--benchmark_dir", bench, "--vis_save_path",
                  str(tmp_path / "v"), *TINY])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        server.main(["--model_preset", "tiny", "--port", "0"])
    assert not os.path.exists(tmp_path / "v0.5")
