"""Writes artifacts/sam_small_encoder_reference.npz: haff_tpu's SAM image
encoder at the `small` preset (512 px, 4 blocks, window 8) with the
trained weights of artifacts/overfit_small_params.npz, on one seeded
image, at bfloat16 (its Pallas kernels in interpret mode, as on any host
without a TPU) and at float32. `chip_smoke.py` runs the port's bf16
encoder on the card on the same image and weights and holds its distance
to the float32 output against the JAX bf16 output's own.

    JAX_PLATFORMS=cpu python tests/make_sam_encoder_reference.py

The image is `np.random.RandomState(seed).randn(1, 512, 512, 3)` as
float32 (already-normalised pixels); the file keeps the seed and the
image's sum, so a reader can check that it regenerated the same image.
Keys: `seed`, `image_sum`, and the encoder's outputs (1, 32, 32, 256)
as float32 (its neck runs in float32 at either dtype): `out_f32`,
`out_bf16`.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARAMS = os.path.join(ROOT, "artifacts", "overfit_small_params.npz")
OUT = os.path.join(ROOT, "artifacts", "sam_small_encoder_reference.npz")


def image(seed: int) -> np.ndarray:
    return np.random.RandomState(seed).randn(1, 512, 512, 3).astype(np.float32)


def encode(params, x, dtype):
    """haff_tpu's SamImageEncoder at `small` in `dtype` (params float32)."""
    import jax
    import jax.numpy as jnp

    from haff_tpu.core.config import SamEncoderConfig
    from haff_tpu.nn.sam_image_encoder import SamImageEncoder

    enc = SamImageEncoder(cfg=SamEncoderConfig.preset("small"), dtype=dtype)
    out = jax.jit(enc.apply)({"params": params}, jnp.asarray(x, dtype))
    return np.asarray(out.astype(jnp.float32))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)  # run as a script from anywhere
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from haff_tpu.tools.export_params import load_exported_params

    params = load_exported_params(PARAMS)["visual_model"]["image_encoder"]
    x = image(args.seed)
    out_f32 = encode(params, x, jnp.float32)
    out_bf16 = encode(params, x, jnp.bfloat16)
    np.savez_compressed(args.out, seed=np.int64(args.seed),
                        image_sum=np.float64(x.astype(np.float64).sum()),
                        out_f32=out_f32, out_bf16=out_bf16)
    rel = (np.linalg.norm(out_bf16 - out_f32) / np.linalg.norm(out_f32))
    print(f"wrote {args.out}: out {out_f32.shape}, JAX bf16 against f32: "
          f"relative L2 {rel:.6g}, max abs {np.abs(out_bf16 - out_f32).max():.6g}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
