"""Stage-1 frame acquisition: EPIC-KITCHENS rgb-frame tar download (port
of haff_tpu/pipeline/acquire.py; host-side, the same code).

Analog of the reference's `2HANDS/download_video.bash:1-19` and the
inline download in `2HANDS/pipeline.bash:10-21`: fetch the per-video
`<video>.tar` of JPEG frames from data.bris.ac.uk (EPIC-55 layout
`frames_rgb_flow/rgb/<split>/<participant>/<video>.tar`, EPIC-100
extension layout `<participant>/rgb_frames/<video>.tar`), extract into
`frames/<participant>/<video>/`, and delete the tar — skipping work the
same way (directory-exists check).

Network egress is optional: `base_url` accepts any scheme urllib
understands (tests use `file://` tars), and `acquire_epic_video` can be
pointed at a mirror.
"""

from __future__ import annotations

import os
import tarfile
import urllib.request

EPIC55_DATASET = "3h91syskeag572hl6tvuovwv4d"
EPIC100_DATASET = "2g1n6qdydwa9u22shpxqzp0t8m"
_BRIS = "https://data.bris.ac.uk/datasets"


def epic_frames_url(participant: str, video: str, split: str = "train",
                    epic100: bool = False, base_url: str = None) -> str:
    """URL of the rgb-frames tar, matching download_video.bash:9-12."""
    if base_url is not None:
        return f"{base_url.rstrip('/')}/{video}.tar"
    if epic100:
        return (f"{_BRIS}/{EPIC100_DATASET}/{participant}/rgb_frames/"
                f"{video}.tar")
    return (f"{_BRIS}/{EPIC55_DATASET}/frames_rgb_flow/rgb/{split}/"
            f"{participant}/{video}.tar")


def _safe_extract(tar: tarfile.TarFile, dest: str) -> int:
    """Extract regular members only, refusing path traversal."""
    n = 0
    dest_real = os.path.realpath(dest)
    for m in tar:
        if not m.isreg():
            continue
        target = os.path.realpath(os.path.join(dest, m.name))
        if not target.startswith(dest_real + os.sep):
            raise ValueError(f"unsafe tar member path: {m.name}")
        tar.extract(m, dest)
        n += 1
    return n


def acquire_epic_video(data_dir: str, participant: str, video: str,
                       split: str = "train", epic100: bool = False,
                       base_url: str = None) -> str:
    """Download+extract one video's frames; returns the frames dir.

    Mirrors the bash flow: no-op if `frames/<participant>/<video>`
    already exists; otherwise fetch the tar, extract into the video
    dir, remove the tar (download_video.bash:2-18)."""
    frames_dir = os.path.join(data_dir, "frames", participant, video)
    if os.path.isdir(frames_dir) and os.listdir(frames_dir):
        return frames_dir
    os.makedirs(frames_dir, exist_ok=True)
    url = epic_frames_url(participant, video, split, epic100, base_url)
    tar_path = os.path.join(data_dir, "frames", participant,
                            f"{video}.tar")
    try:
        urllib.request.urlretrieve(url, tar_path)
        with tarfile.open(tar_path) as tf:
            n = _safe_extract(tf, frames_dir)
        if n == 0:
            raise ValueError(f"no files in {url}")
    finally:
        if os.path.exists(tar_path):
            os.remove(tar_path)
    return frames_dir
