"""Training-time visualization: periodic result grids (counterpart of
pnp_vcve_tpu/train/visualization.py; reference mmedit/core/hooks/
visualization.py:11-84, ``VisualizationHook``).

Every ``interval`` iterations the requested results are tiled into one
image grid (``nrow`` tiles a row, ``padding`` pixels between tiles, an
optional [-1, 1] -> [0, 1] rerange) and saved as ``iter_{N}.png`` under
``output_dir``. The shipped configs disable it (``visual_config=None``).
Numpy and PIL only; tools/torch_train.py installs the hook on rank 0 only,
as the reference's ``@master_only`` does.
"""

from __future__ import annotations

import os
from typing import Mapping, Sequence

import numpy as np

__all__ = ["make_image_grid", "VisualizationHook"]


def make_image_grid(images: Sequence[np.ndarray], nrow: int = 1, padding: int = 4,
                    rerange: bool = True) -> np.ndarray:
    """Tile (h, w, c) float images into one uint8 grid (torchvision
    ``save_image``'s layout: ``nrow`` images a grid row, zero padding)."""
    imgs = [np.asarray(im, np.float32) for im in images]
    if rerange:
        imgs = [(im + 1.0) / 2.0 for im in imgs]
    imgs = [np.clip(im, 0.0, 1.0) for im in imgs]
    h = max(im.shape[0] for im in imgs)
    w = max(im.shape[1] for im in imgs)
    c = imgs[0].shape[2]
    ncols = max(1, nrow)
    nrows = -(-len(imgs) // ncols)
    grid = np.zeros((nrows * (h + padding) - padding, ncols * (w + padding) - padding, c),
                    np.float32)
    for i, im in enumerate(imgs):
        r, col = divmod(i, ncols)
        y, x = r * (h + padding), col * (w + padding)
        grid[y:y + im.shape[0], x:x + im.shape[1]] = im
    return (grid * 255.0 + 0.5).astype(np.uint8)


class VisualizationHook:
    """``hook(step, results)``: ``results`` maps names to (b, h, w, c) or
    (b, t, h, w, c) arrays (the middle frame is shown); saves
    ``filename_tmpl.format(step + 1)`` on the interval and returns its path."""

    def __init__(self, output_dir: str, res_name_list: Sequence[str], interval: int = -1,
                 filename_tmpl: str = "iter_{}.png", rerange: bool = True, nrow: int = 1,
                 padding: int = 4):
        self.output_dir = output_dir
        self.res_name_list = list(res_name_list)
        self.interval = interval
        self.filename_tmpl = filename_tmpl
        self.rerange = rerange
        self.nrow = nrow
        self.padding = padding
        os.makedirs(output_dir, exist_ok=True)

    def __call__(self, step: int, results: Mapping[str, np.ndarray]):
        if self.interval <= 0 or (step + 1) % self.interval != 0:
            return None
        tiles = []
        for name in self.res_name_list:
            if name not in results:
                continue
            arr = np.asarray(results[name])
            if arr.ndim == 5:
                arr = arr[:, arr.shape[1] // 2]
            tiles.extend(arr[i] for i in range(min(arr.shape[0], self.nrow)))
        if not tiles:
            return None
        grid = make_image_grid(tiles, nrow=self.nrow, padding=self.padding,
                               rerange=self.rerange)
        from PIL import Image

        path = os.path.join(self.output_dir, self.filename_tmpl.format(step + 1))
        Image.fromarray(grid.squeeze() if grid.shape[-1] == 1 else grid).save(path)
        return path
