"""Vicuna-style delta-weight arithmetic (apply / make / consolidate); port
of haff_tpu/tools/delta_weights.py, the same numpy code.

Capability parity with reference 2Haff/model/llava/model/apply_delta.py
:14-47, make_delta.py:14-47 and consolidate.py: the LLaVA/vicuna weight
distribution ships DELTAS against the raw LLaMA base; `apply_delta`
reconstructs the target (target = base + delta), `make_delta` produces a
distributable delta (delta = target - base), `consolidate` just re-saves
a sharded checkpoint as one file. Reference semantics reproduced:

  * keys present only in the delta must be in the known multimodal
    allowlist (mm_projector.*) and pass through unchanged;
  * embed_tokens / lm_head may be LARGER in the delta (vocab extended
    with special tokens): the base adds into the leading
    [: base_rows, : base_cols] block, the extra rows stay delta-only.

Operates on local torch/safetensors state dicts (the format the deltas
are distributed in) so the output feeds tools/convert_cli directly; no
torch model classes are instantiated (the reference loads full
LlavaLlamaForCausalLM modules — unnecessary for pure tensor
arithmetic, and this version runs in host memory for 13B).

Usage:
  python -m haff_tpu_torch.tools.delta_weights apply --base B --delta D --out T
  python -m haff_tpu_torch.tools.delta_weights make  --base B --target T --out D
  python -m haff_tpu_torch.tools.delta_weights consolidate --src DIR --out F
"""

from __future__ import annotations

import argparse
import glob
import os
from typing import Dict

import numpy as np

# Keys allowed to exist only on the delta/target side (reference
# apply_delta.py:28-33).
EXTRA_KEY_SUFFIXES = ("mm_projector.weight", "mm_projector.bias")

# Keys allowed to differ in shape (vocab-extended rows; reference
# apply_delta.py:36-41).
RESIZED_KEY_SUFFIXES = ("embed_tokens.weight", "lm_head.weight")


def _load_dir_or_file(path: str) -> Dict[str, np.ndarray]:
    from .convert_weights import load_state_dict

    if os.path.isdir(path):
        sd: Dict[str, np.ndarray] = {}
        for f in sorted(glob.glob(os.path.join(path, "*.safetensors"))
                        + glob.glob(os.path.join(path, "*.bin"))
                        + glob.glob(os.path.join(path, "*.pth"))):
            sd.update(load_state_dict(f))
        if not sd:
            raise FileNotFoundError(f"no checkpoint files under {path}")
        return sd
    return load_state_dict(path)


def _combine(a: Dict[str, np.ndarray], b: Dict[str, np.ndarray],
             sign: float) -> Dict[str, np.ndarray]:
    """out[k] = a[k] + sign * b[k] with the reference's extra-key and
    vocab-resize rules; `a` drives the output key set."""
    out: Dict[str, np.ndarray] = {}
    for name, va in a.items():
        if name not in b:
            if not name.endswith(EXTRA_KEY_SUFFIXES):
                raise KeyError(f"{name} missing from base model and not "
                               f"in the multimodal allowlist")
            out[name] = va
            continue
        vb = b[name]
        if va.shape == vb.shape:
            out[name] = va + sign * vb
        else:
            if not name.endswith(RESIZED_KEY_SUFFIXES):
                raise ValueError(
                    f"{name} shape mismatch {va.shape} vs {vb.shape} "
                    f"(only embed_tokens/lm_head may be vocab-extended)")
            # One-directional vocab extension only (reference
            # apply_delta.py indexes delta[:base.shape[0], :base.shape[1]]
            # += base and would error on the inversion) — a base LARGER
            # than the delta/target must fail loudly, not silently
            # truncate.
            if not all(da >= db for da, db in zip(va.shape, vb.shape)):
                raise ValueError(
                    f"{name}: the iterated side's shape {va.shape} must "
                    f"cover the other side's {vb.shape} (vocab extension "
                    f"is one-directional)")
            r = np.array(va, copy=True)
            r[:vb.shape[0], :vb.shape[1]] += sign * vb
            out[name] = r
    return out


def apply_delta(base: Dict[str, np.ndarray],
                delta: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """target = delta + base (reference apply_delta.py:26-41: iterates
    the DELTA's state dict, so delta-only keys survive and the target
    inherits the delta's extended vocab rows)."""
    return _combine(delta, base, +1.0)


def make_delta(target: Dict[str, np.ndarray],
               base: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """delta = target - base (reference make_delta.py:26-41)."""
    return _combine(target, base, -1.0)


def save_state_dict(sd: Dict[str, np.ndarray], path: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".",
                exist_ok=True)
    if path.endswith(".safetensors"):
        from safetensors.numpy import save_file

        save_file({k: np.ascontiguousarray(v) for k, v in sd.items()},
                  path)
        return
    import torch

    torch.save({k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in sd.items()}, path)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)
    ap = sub.add_parser("apply", help="target = base + delta")
    ap.add_argument("--base", required=True)
    ap.add_argument("--delta", required=True)
    ap.add_argument("--out", required=True)
    mk = sub.add_parser("make", help="delta = target - base")
    mk.add_argument("--base", required=True)
    mk.add_argument("--target", required=True)
    mk.add_argument("--out", required=True)
    co = sub.add_parser("consolidate",
                        help="merge a sharded checkpoint dir into one "
                             "file (reference consolidate.py)")
    co.add_argument("--src", required=True)
    co.add_argument("--out", required=True)
    args = p.parse_args(argv)

    if args.cmd == "apply":
        out = apply_delta(_load_dir_or_file(args.base),
                          _load_dir_or_file(args.delta))
    elif args.cmd == "make":
        out = make_delta(_load_dir_or_file(args.target),
                         _load_dir_or_file(args.base))
    else:
        out = _load_dir_or_file(args.src)
    save_state_dict(out, args.out)
    print(f"{args.cmd}: wrote {len(out)} tensors to {args.out}")


if __name__ == "__main__":
    main()
