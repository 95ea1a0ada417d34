"""Scene parser (port of ``nrhints_tpu/data/parser.py``): a NeRF-Blender
``transforms_{train,val,test}.json`` scene with a point-light position per
frame, loaded into numpy arrays in host memory.

Per frame: ``file_path``, optional ``file_ext`` (.png, .exr or .npy),
``pl_pos`` and ``transform_matrix``; intrinsics from ``camera_intrinsics``
[cx, cy, fx, fy] or else ``camera_angle_x``; ``camera_near`` / ``camera_far``
default to 3 and 10.  ``half_res`` halves the images by area averaging and
halves every intrinsic, ``cx`` included (the original code halved ``cy``
into ``cx``, a typo the JAX package fixed too).  ``white_background``
composites RGBA over white; otherwise the alpha is dropped.

Images other than ``.npy`` are read through ``imageio.v3`` where it is
installed, as the JAX package reads them (any format imageio reads: palette
and interlaced PNGs, ``.jpg``, PIZ-compressed EXRs), else by the package's
own readers (``data/png.py``, ``data/exr.py``, numpy + zlib), which raise
with the reason on a format they lack; an EXR that imageio cannot read
falls back to ``data/exr.py``.  8-bit images are divided by 255; any other
integer image (a 16-bit PNG) raises ``NotImplementedError``.
"""
from __future__ import annotations

import json
import pathlib
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

from nrhints_torch.camera.model import CameraModel
from nrhints_torch.data.exr import read_exr
from nrhints_torch.data.png import read_png


@dataclass
class SceneData:
    """Everything loaded from one scene directory (host memory)."""

    images: np.ndarray  # [N, H, W, 3] float32
    poses: np.ndarray  # [N, 4, 4] float32 camera-to-world
    pls: np.ndarray  # [N, 3] float32 point-light positions
    camera: CameraModel
    num_image_per_split: List[int]  # [train, val, test]

    @property
    def total_image_num(self) -> int:
        return int(self.images.shape[0])


def _load_image(path: pathlib.Path, ext: str) -> np.ndarray:
    if ext == ".npy":
        return np.load(path)
    try:
        import imageio.v3 as iio
    except ImportError:
        iio = None
    if ext == ".exr":  # float HDR, no scaling
        if iio is not None:
            try:
                return iio.imread(path)
            except Exception:
                pass
        return read_exr(path)
    img = read_png(path) if iio is None else iio.imread(path)
    if img.dtype != np.uint8:
        raise NotImplementedError(f"{path}: {img.dtype} image; the parser takes 8-bit images, .exr and .npy")
    return img / 255.0


def _area_weights(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] weights of an area-averaging resize along one axis:
    output pixel i averages the input over [i * s, (i + 1) * s), s = n_in /
    n_out, each input pixel weighted by its overlap.  For n_in = 2 n_out it
    is the 2-tap box mean."""
    s = n_in / n_out
    lo = np.arange(n_out)[:, None] * s
    edges = np.arange(n_in + 1)[None, :]
    overlap = np.clip(np.minimum(edges[:, 1:], lo + s) - np.maximum(edges[:, :-1], lo), 0.0, None)
    return overlap / s


def resize_area(img: np.ndarray, H: int, W: int) -> np.ndarray:
    """[h, w, C] -> [H, W, C] by area averaging (OpenCV's INTER_AREA when
    shrinking)."""
    wy = _area_weights(img.shape[0], H)
    wx = _area_weights(img.shape[1], W)
    return np.einsum("Hh,hwc,Ww->HWc", wy, img.astype(np.float64), wx)


def parse_load_nr_data(
    basedir,
    splits: Optional[Sequence[str]] = None,
    half_res: bool = False,
    white_background: bool = True,
) -> SceneData:
    """Load all splits of a scene into host RAM -> SceneData."""
    if splits is None:
        splits = ["train", "val", "test"]
    basedir = pathlib.Path(basedir)

    metas = {}
    for s in splits:
        with open(basedir / f"transforms_{s}.json") as fp:
            metas[s] = json.load(fp)
    num_image_per_split = [len(metas[s]["frames"]) for s in splits]
    total = sum(num_image_per_split)

    meta = metas[splits[0]]
    zn = float(meta.get("camera_near", 3.0))
    zf = float(meta.get("camera_far", 10.0))

    first_frame = meta["frames"][0]
    first_ext = first_frame.get("file_ext", ".png")
    first_image = _load_image(basedir / (first_frame["file_path"] + first_ext), first_ext)
    H, W = first_image.shape[:2]

    if "camera_intrinsics" in meta:
        cx, cy, fx, fy = (float(v) for v in meta["camera_intrinsics"])
    else:
        camera_angle_x = float(meta["camera_angle_x"])
        focal = 0.5 * W / np.tan(0.5 * camera_angle_x)
        cx, cy, fx, fy = W / 2.0, H / 2.0, focal, focal

    if half_res:
        H, W = H // 2, W // 2
        cx, cy, fx, fy = cx / 2.0, cy / 2.0, fx / 2.0, fy / 2.0

    images = np.empty((total, H, W, 3), dtype=np.float32)
    poses = np.empty((total, 4, 4), dtype=np.float32)
    pls = np.empty((total, 3), dtype=np.float32)

    idx = 0
    for s in splits:
        for frame in metas[s]["frames"]:
            ext = frame.get("file_ext", ".png")
            img = first_image if idx == 0 else _load_image(basedir / (frame["file_path"] + ext), ext)
            if half_res:
                img = resize_area(img, H, W)
            if white_background and img.shape[-1] == 4:
                img = img[..., :3] * img[..., 3:] + (1.0 - img[..., 3:])
            else:
                img = img[..., :3]
            images[idx] = img.astype(np.float32)
            poses[idx] = np.asarray(frame["transform_matrix"], dtype=np.float32)
            pls[idx] = np.asarray(frame.get("pl_pos", [0.0, 0.0, 0.0]), dtype=np.float32)
            idx += 1

    return SceneData(
        images=images,
        poses=poses,
        pls=pls,
        camera=CameraModel(H, W, cx, cy, fx, fy, zn, zf),
        num_image_per_split=list(num_image_per_split),
    )
