"""Boundaries of the PyTorch port: it never imports JAX, Flax or the JAX
package, and its entry points run on the card unless the caller asks for
the CPU."""

import ast
import pathlib

import pytest
import torch

from haff_tpu_torch.core.config import ModelConfig
from haff_tpu_torch.model.lisa import LisaModel

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "haff_tpu")


def _sources():
    return sorted((ROOT / "haff_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None)
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(
    p.relative_to(ROOT)))
def test_no_jax_flax_or_reference_imports(path):
    for name in _imported(ast.parse(path.read_text(), str(path))):
        top = name.split(".")[0]
        assert top not in FORBIDDEN, f"{path.name} imports {name}"


# transformers only where the port reads HF files: a local tokenizer and
# the parity harness, each inside a function (the port imports without it).
TRANSFORMERS_AT = ("haff_tpu_torch/data/tokenizer.py",
                   "haff_tpu_torch/tools/parity_check.py")


def test_transformers_only_inside_functions_where_allowed():
    def hf(names):
        return any(n.split(".")[0] == "transformers" for n in names)

    for path in _sources():
        tree = ast.parse(path.read_text(), str(path))
        top = [n for n in tree.body if isinstance(n, (ast.Import,
                                                      ast.ImportFrom))]
        assert not hf(_imported(ast.Module(body=top, type_ignores=[]))), path
        if str(path.relative_to(ROOT)) not in TRANSFORMERS_AT:
            assert not hf(_imported(tree)), path


def test_the_walk_covers_every_module_of_the_port():
    names = {str(p.relative_to(ROOT)) for p in _sources()}
    for rel in ("haff_tpu_torch/infer/sam_predictor.py",
                "haff_tpu_torch/infer/amg.py",
                "haff_tpu_torch/data/transforms.py",
                "haff_tpu_torch/tools/bridge.py",
                "haff_tpu_torch/tools/parity_check.py",
                "haff_tpu_torch/tools/kernel_audit.py",
                "haff_tpu_torch/tools/bench_kernels.py",
                "haff_tpu_torch/data/tokenizer.py",
                "haff_tpu_torch/data/prompts.py",
                "haff_tpu_torch/data/collate.py",
                "haff_tpu_torch/data/aff_dataset.py",
                "haff_tpu_torch/eval/tools.py",
                "haff_tpu_torch/infer/predictor.py",
                "haff_tpu_torch/infer/server.py",
                "haff_tpu_torch/infer/streaming.py",
                "haff_tpu_torch/infer/cli.py",
                "haff_tpu_torch/infer/chat.py",
                "haff_tpu_torch/infer/app.py",
                "haff_tpu_torch/infer/robot_demo.py",
                "haff_tpu_torch/eval/metrics.py",
                "haff_tpu_torch/eval/annotations.py",
                "haff_tpu_torch/eval/benchmark.py",
                "haff_tpu_torch/data/loader.py",
                "haff_tpu_torch/data/seg_datasets.py",
                "haff_tpu_torch/data/extra_datasets.py",
                "haff_tpu_torch/tools/convert_weights.py",
                "haff_tpu_torch/train/metrics.py",
                "haff_tpu_torch/train/checkpoints.py",
                "haff_tpu_torch/train/cli.py", "haff_tpu_torch/nn/mpt.py",
                "haff_tpu_torch/pipeline/ops.py",
                "haff_tpu_torch/pipeline/defaults.py",
                "haff_tpu_torch/pipeline/orchestrate.py",
                "haff_tpu_torch/pipeline/annotations.py",
                "haff_tpu_torch/pipeline/acquire.py",
                "haff_tpu_torch/pipeline/cli.py",
                "haff_tpu_torch/tools/export_model.py",
                "haff_tpu_torch/tools/export_params.py",
                "haff_tpu_torch/tools/merge_lora.py",
                "haff_tpu_torch/tools/convert_cli.py",
                "haff_tpu_torch/tools/delta_weights.py",
                "haff_tpu_torch/tools/bench_to_shards.py",
                "haff_tpu_torch/data/native.py",
                "haff_tpu_torch/utils/profiling.py",
                "haff_tpu_torch/utils/flops.py",
                "haff_tpu_torch/utils/bench_cache.py",
                "haff_tpu_torch/core/mesh.py",
                "haff_tpu_torch/parallel/__init__.py",
                "haff_tpu_torch/parallel/collectives.py",
                "haff_tpu_torch/parallel/ring_attention.py",
                "haff_tpu_torch/parallel/sharding.py",
                "chip_smoke.py"):
        assert rel in names, rel


def test_train_cli_defaults_to_the_card(tmp_path):
    """The train CLI runs on the card unless asked for the CPU: without
    --device and with no card it raises before touching any data."""
    from haff_tpu_torch.train import cli

    assert cli.parse_args(["--dataset_dir", "d"]).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["--dataset_dir", str(tmp_path / "none"),
                      "--model_preset", "tiny",
                      "--log_base_dir", str(tmp_path / "runs")])


def test_model_defaults_to_the_card():
    cfg = ModelConfig.preset("tiny")
    if torch.cuda.is_available():
        assert LisaModel(cfg).device.type == "cuda"
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            LisaModel(cfg)
    assert LisaModel(cfg, torch.float32, device="cpu").device.type == "cpu"


def test_mpt_model_defaults_to_the_card():
    cfg = ModelConfig.preset("tiny").replace(decoder="mpt")
    if torch.cuda.is_available():
        assert LisaModel(cfg).device.type == "cuda"
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            LisaModel(cfg)
    model = LisaModel(cfg, torch.float32, device="cpu")
    assert model.device.type == "cpu"
    assert type(model.llm).__name__ == "MptForCausalLM"


@pytest.mark.parametrize("entry", [
    ("haff_tpu_torch.pipeline.cli", ["--frames_dir", "F", "--out_dir", "O"]),
    ("haff_tpu_torch.tools.export_model", ["--out", "x.pt2"]),
    ("haff_tpu_torch.tools.export_params", ["--ckpt_dir", "C", "--out", "x"]),
])
def test_device_entry_points_default_to_the_card(entry):
    """The pipeline CLI, export_model and export_params take --device,
    default cuda."""
    import argparse
    import importlib

    module, argv = entry
    mod = importlib.import_module(module)
    seen = {}
    real = argparse.ArgumentParser.parse_args

    def parse(self, args=None, namespace=None):
        seen["args"] = real(self, args, namespace)
        raise SystemExit(0)

    argparse.ArgumentParser.parse_args = parse
    try:
        with pytest.raises(SystemExit):
            mod.main(argv)
    finally:
        argparse.ArgumentParser.parse_args = real
    assert seen["args"].device == "cuda"
