"""The committed reference of haff_tpu's SAM encoder at the small preset
(artifacts/sam_small_encoder_reference.npz, written by
tests/make_sam_encoder_reference.py) against the port on the CPU:

* the seeded image regenerates bit for bit (the file's image sum);
* the port's float32 encoder, with the same trained weights, is within
  1e-4 of haff_tpu's float32 output;
* the port's bf16 encoder (plain versions of the kernels on the CPU) is
  no further from the float32 output than twice haff_tpu's bf16 output
  (its Pallas kernels in interpret mode), by relative L2 and by max abs:
  the bound `chip_smoke.py` holds the card's kernels to.
"""

import numpy as np
import pytest
import torch

from haff_tpu_torch.core.config import SamDecoderConfig, SamEncoderConfig
from haff_tpu_torch.nn.sam import Sam
from haff_tpu_torch.tools.bridge import load_jax_params
from make_sam_encoder_reference import OUT, PARAMS, image


@pytest.fixture(scope="module")
def reference():
    with np.load(OUT) as z:
        ref = {k: z[k] for k in z.files}
    x = image(int(ref["seed"]))
    sam = load_jax_params(Sam(SamEncoderConfig.preset("small"),
                              SamDecoderConfig()), PARAMS,
                          scope="visual_model")
    return ref, x, sam.image_encoder


def _dist(a, ref):
    return (float(np.linalg.norm(a - ref) / np.linalg.norm(ref)),
            float(np.abs(a - ref).max()))


def test_the_seeded_image_regenerates(reference):
    ref, x, _ = reference
    assert x.shape == (1, 512, 512, 3)
    assert x.astype(np.float64).sum() == float(ref["image_sum"])
    assert ref["out_f32"].shape == ref["out_bf16"].shape == (1, 32, 32, 256)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_port_encoder_against_the_reference(reference, dtype):
    ref, x, enc = reference
    with torch.no_grad():
        got = enc.to(dtype)(torch.from_numpy(x)).float().numpy()
    enc.float()
    l2, mx = _dist(got, ref["out_f32"])
    if dtype == torch.float32:
        assert mx < 1e-4
    else:
        jl2, jmx = _dist(ref["out_bf16"], ref["out_f32"])
        assert 0 < jl2 and l2 <= 2 * jl2 and mx <= 2 * jmx
