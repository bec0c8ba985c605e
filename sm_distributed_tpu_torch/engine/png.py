"""Colormapped PNG rendering of ion images.

Port of ``sm_distributed_tpu/engine/png.py``: RGBA PNG bytes through Pillow
(imported when an image is rendered) and a viridis-like colormap computed
directly, pixels outside the sample-area mask transparent.
"""

from __future__ import annotations

import io
from pathlib import Path

import numpy as np

# 10-anchor viridis approximation (full range through the yellow end),
# linearly interpolated to 256 entries.
_ANCHORS = np.array([
    [68, 1, 84], [72, 40, 120], [62, 74, 137], [49, 104, 142],
    [38, 130, 142], [31, 158, 137], [53, 183, 121], [109, 205, 89],
    [180, 222, 44], [253, 231, 37],
], dtype=np.float64)


def _viridis256() -> np.ndarray:
    x = np.linspace(0, len(_ANCHORS) - 1, 256)
    lo = np.clip(np.floor(x).astype(int), 0, len(_ANCHORS) - 2)
    frac = (x - lo)[:, None]
    return np.clip(_ANCHORS[lo] * (1 - frac) + _ANCHORS[lo + 1] * frac, 0, 255
                   ).astype(np.uint8)


class PngGenerator:
    """Render a 2-D intensity image to RGBA PNG bytes/file."""

    def __init__(self, mask: np.ndarray | None = None):
        # pixels outside the sample-area mask render transparent
        self.mask = mask
        self._lut = _viridis256()

    def render(self, img: np.ndarray) -> bytes:
        from PIL import Image

        img = np.asarray(img, dtype=np.float64)
        vmax = img.max()
        norm = (img / vmax * 255).astype(np.uint8) if vmax > 0 else np.zeros(
            img.shape, dtype=np.uint8
        )
        rgba = np.zeros((*img.shape, 4), dtype=np.uint8)
        rgba[..., :3] = self._lut[norm]
        rgba[..., 3] = 255
        if self.mask is not None:
            rgba[~self.mask] = 0
        buf = io.BytesIO()
        Image.fromarray(rgba, mode="RGBA").save(buf, format="PNG")
        return buf.getvalue()

    def save(self, img: np.ndarray, path: str | Path) -> Path:
        path = Path(path)
        path.write_bytes(self.render(img))
        return path
