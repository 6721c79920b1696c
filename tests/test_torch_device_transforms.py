"""The streaming path's device preprocessing
(haff_tpu_torch/data/transforms.py device_sam_preprocess,
device_clip_preprocess) against haff_tpu's jax.image.resize versions, for
frames that upsample and frames that downsample (jax.image.resize
antialiases only an axis that shrinks): within 1e-4 absolute on the
normalised output, the same resize shape."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from haff_tpu.data import transforms as jt
from haff_tpu_torch.data import transforms as tt

FRAMES = [(60, 90), (100, 30), (720, 1280), (300, 1100), (128, 64)]


def _frames(hw, dtype=np.uint8):
    x = np.random.RandomState(sum(hw)).rand(2, *hw, 3) * 255
    return x.astype(dtype)


@pytest.mark.parametrize("hw", FRAMES)
@pytest.mark.parametrize("size", [128, 1024])
def test_sam_preprocess_matches(hw, size):
    f = _frames(hw)
    ref, ref_hw = jt.device_sam_preprocess(jnp.asarray(f), size)
    got, got_hw = tt.device_sam_preprocess(torch.from_numpy(f), size)
    assert got_hw == ref_hw
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-4)
    # The padding is exactly zero.
    assert not got[:, got_hw[0]:].any() and not got[:, :, got_hw[1]:].any()


@pytest.mark.parametrize("hw", FRAMES)
@pytest.mark.parametrize("size", [32, 224])
def test_clip_preprocess_matches(hw, size):
    f = _frames(hw)
    ref = jt.device_clip_preprocess(jnp.asarray(f), size)
    got = tt.device_clip_preprocess(torch.from_numpy(f), size)
    assert tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-4)


def test_float_frames_and_explicit_resize_shape():
    f = _frames((50, 70), np.float32)
    ref, _ = jt.device_sam_preprocess(jnp.asarray(f), 128, (40, 128))
    got, hw = tt.device_sam_preprocess(torch.from_numpy(f), 128, (40, 128))
    assert hw == (40, 128)  # rows shrink, columns grow: two passes
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-4)
