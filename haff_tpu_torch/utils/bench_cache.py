"""Sidecar cache for bench legs, keyed by a hash of the measured code
(port of haff_tpu/utils/bench_cache.py).

A bench leg measured at the current code may be reused by a later run
of the same code, marked as cached. The key is a content hash (not a git
sha) of haff_tpu_torch/ and the scripts that drive it, so a commit
that does not touch them keeps the legs valid. The port's cache is its
own file, `.bench_cache_torch.json` at the root of the checkout
(git-ignored), apart from the JAX package's.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Optional

_ROOT = os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))
_PATH = os.path.join(_ROOT, ".bench_cache_torch.json")
# Scripts beside the package whose code the legs measure.
SCRIPTS = ("chip_smoke.py",)


def code_hash() -> str:
    """md5 over haff_tpu_torch/'s sources, its kernels' CUDA sources and
    those scripts (sorted relative paths and contents)."""
    h = hashlib.md5()
    files = []
    for base, _, names in os.walk(os.path.join(_ROOT, "haff_tpu_torch")):
        if "__pycache__" in base:
            continue
        files.extend(os.path.join(base, n) for n in names
                     if n.endswith((".py", ".cu", ".cuh")))
    files.extend(os.path.join(_ROOT, n) for n in SCRIPTS
                 if os.path.exists(os.path.join(_ROOT, n)))
    for path in sorted(files):
        h.update(os.path.relpath(path, _ROOT).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()


def _load() -> dict:
    try:
        with open(_PATH) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def store(leg: str, fields: dict) -> None:
    """Persist one leg's measured fields under the current code hash."""
    data = _load()
    key = code_hash()
    if data.get("code_hash") != key:
        data = {"code_hash": key}
    data[leg] = dict(fields)
    with open(_PATH, "w") as f:
        json.dump(data, f)


def load(leg: str) -> Optional[dict]:
    """The leg's fields if cached at the CURRENT code, else None."""
    data = _load()
    if data.get("code_hash") != code_hash():
        return None
    return data.get(leg)
