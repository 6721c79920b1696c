"""The one traffic generator: every cell's requests come from its file's
`traffic` parameters and the run's seed, sent by one client in a closed
loop (harness.py).

    frames          how many distinct frames the clip holds (cycled)
    height, width   frame size (VISOR's 480 x 854)
    prompt_chars    [min, max] characters of a bimanual instruction

Every seed gives the same amount of work in another order: each frame
has the same size, and each prompt is padded to the same text length by
the program. Request i's inputs depend only on (seed, i), so the check
after the window makes them again.
"""

from __future__ import annotations

import numpy as np

OBJECTS = ("the jar", "the bottle", "the lid", "the kettle", "the drawer",
           "the towel", "the knife", "the cutting board", "the pan",
           "the box", "the cup", "the bag", "the laptop", "the bowl",
           "the door", "the spoon", "the sponge", "the cloth")
ACTIONS = ("open", "close", "pour from", "cut", "hold", "fold", "lift",
           "wipe", "stir", "carry", "unscrew", "push", "pull", "turn")
HOW = ("with both hands", "using the left hand to steady it",
       "holding it with the right hand", "with one hand on each side",
       "while the other hand keeps it still", "")


def _rng(seed: int, *key: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & 0xFFFFFFFF,
                                  (int(seed) >> 32) & 0xFFFFFFFF, *key])


def frame(seed: int, index: int, height: int, width: int) -> np.ndarray:
    """A smooth seeded RGB frame (low-frequency colour fields plus
    grain), uint8 (height, width, 3)."""
    from PIL import Image

    r = _rng(seed, 1, index)
    base = r.integers(0, 256, (height // 16 + 1, width // 16 + 1, 3), np.uint8)
    img = np.asarray(Image.fromarray(base).resize((width, height),
                                                  Image.BICUBIC), np.float32)
    img = img + r.normal(0, 12, (height, width, 3)).astype(np.float32)
    return np.clip(img, 0, 255).astype(np.uint8)


def prompt(seed: int, index: int, chars) -> str:
    """A bimanual instruction of chars[0]..chars[1] characters."""
    r = _rng(seed, 2, index)
    lo, hi = chars
    want = int(r.integers(lo, hi + 1))
    text = ""
    while len(text) < want:
        obj, act = r.choice(OBJECTS), r.choice(ACTIONS)
        how = r.choice(HOW)
        clause = f"{act} {obj}" + (f" {how}" if how else "")
        text = (text + " and then " + clause) if text else (
            f"Where would you put your hands to {clause}")
    text = text[:want].rstrip()
    return text + "?" if len(text) < hi else text[:hi - 1] + "?"
