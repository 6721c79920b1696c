"""The port's StreamingPipeline (haff_tpu_torch/infer/streaming.py) against
haff_tpu's on a 5-frame clip in chunks of 2 (the last chunk padded), at
the tiny preset in float32 on the CPU with the same bridged weights:
prompt tokenized once, frames preprocessed where the model is, evaluate
per chunk. Chunk starts and resize shapes equal; masks and taxonomy
within 1e-4."""

import numpy as np
import pytest

from haff_tpu.data.tokenizer import ByteTokenizer as JaxByteTokenizer
from haff_tpu.infer.streaming import StreamingPipeline as JaxStreamingPipeline
from haff_tpu_torch.data.tokenizer import ByteTokenizer
from haff_tpu_torch.infer.streaming import StreamingPipeline
from test_torch_bridge import jax_tiny_params, port_model

KW = dict(chunk=2, max_new_tokens=4, max_text_len=112)


@pytest.fixture(scope="module")
def runs():
    jmodel, params = jax_tiny_params(seed=3)
    clip = (np.random.RandomState(5).rand(5, 72, 100, 3) * 255).astype(
        np.uint8)
    ref = list(JaxStreamingPipeline(jmodel, {"params": params},
                                    JaxByteTokenizer(), "open drawer",
                                    **KW).run(clip))
    got = list(StreamingPipeline(port_model(params), ByteTokenizer(),
                                 "open drawer", **KW).run(clip))
    return ref, got


def test_chunks_and_shapes(runs):
    ref, got = runs
    assert [c["start"] for c in got] == [c["start"] for c in ref] == [0, 2, 4]
    for g, r in zip(got, ref):
        assert g["resize_hw"] == r["resize_hw"]
        for key in ("masks_left", "masks_right", "taxonomies"):
            assert g[key].shape == np.asarray(r[key]).shape, key
    assert got[-1]["masks_left"].shape[0] == 1  # the padding is dropped


@pytest.mark.parametrize("key", ["masks_left", "masks_right", "taxonomies"])
def test_outputs_match(runs, key):
    ref, got = runs
    for g, r in zip(got, ref):
        assert np.isfinite(g[key]).all()
        np.testing.assert_allclose(g[key], np.asarray(r[key]), rtol=1e-4,
                                   atol=1e-4)


def test_feeder_failure_reaches_the_consumer():
    _, params = jax_tiny_params(seed=3)
    pipe = StreamingPipeline(port_model(params), ByteTokenizer(), "x", **KW)

    class Unreadable:  # a clip whose frames cannot be read
        shape = (4, 8, 8, 3)

        def __getitem__(self, index):
            raise ValueError("unreadable frames")

    with pytest.raises(ValueError, match="unreadable frames"):
        list(pipe.run(Unreadable()))
