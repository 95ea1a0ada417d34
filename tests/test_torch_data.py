"""The port's data modules on the CPU against the JAX package's: the scene
parser, the EXR codec, the video poses, the procedural scene writer and the
DataManager, on a 16 x 16 scene of 4 train, 1 val and 2 test views that
``make_hints_scene`` writes to a temporary directory; and the port's own
PNG codec and area resize against imageio and OpenCV.

Tolerances: the parser's arrays and camera, the EXR files and pixels, the
scene files and the DataManager's batches are exact (the same decoders and
the same numpy arithmetic); at ``half_res`` the port's area resize runs
its own float64 sums, 1e-6 (measured 0 for even sizes against OpenCV's
INTER_AREA); the video poses 1e-6 (the same float32 numpy products).
"""
import json
import struct
import zlib

import numpy as np
import pytest
import torch

from nrhints_torch.camera import video_poses as tvp
from nrhints_torch.data import exr as texr
from nrhints_torch.data import parser as tparser
from nrhints_torch.data.manager import DataManager as TDM
from nrhints_torch.data.png import read_png, write_png
from nrhints_torch.data.synthetic import make_hints_scene
from nrhints_tpu.camera import video_poses as jvp
from nrhints_tpu.data import exr as jexr
from nrhints_tpu.data import parser as jparser
from nrhints_tpu.data.manager import DataManager as JDM
from nrhints_tpu.data.synthetic import make_hints_scene as jax_make_hints_scene

SPLITS = {"train": 4, "val": 1, "test": 2}


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    return make_hints_scene(tmp_path_factory.mktemp("scene"), *SPLITS.values(), H=16, W=16)


def _png_bytes(img: np.ndarray, ftype) -> bytes:
    """An 8-bit PNG of ``img`` [H, W, C] with every row under filter ``ftype``
    (an int, or one a row)."""
    H, W, C = img.shape
    bpp, stride = C, W * C
    raw = img.reshape(H, stride).astype(np.int64)
    rows = []
    for y, ftype in enumerate(np.broadcast_to(ftype, (H,)).tolist()):
        prior = raw[y - 1] if y else np.zeros(stride, np.int64)
        left = np.concatenate([np.zeros(bpp, np.int64), raw[y, :-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prior[:-bpp]])
        if ftype == 0:
            pred = np.zeros(stride, np.int64)
        elif ftype == 1:
            pred = left
        elif ftype == 2:
            pred = prior
        elif ftype == 3:
            pred = (left + prior) // 2
        else:
            p = left + prior - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prior), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prior, upleft))
        rows.append(bytes([ftype]) + ((raw[y] - pred) % 256).astype(np.uint8).tobytes())

    def chunk(t, d):
        return struct.pack(">I", len(d)) + t + d + struct.pack(">I", zlib.crc32(t + d))

    color = {1: 0, 2: 4, 3: 2, 4: 6}[C]
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(rows))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_png_codec_against_imageio(tmp_path, channels):
    """The reader undoes all five row filters, alone and mixed row by row,
    on tall and wide images (files built here, and imageio's own), the
    writer's files read back through imageio: exact."""
    import imageio.v3 as iio

    rng = np.random.default_rng(channels)
    smooth = np.cumsum(np.cumsum(rng.integers(0, 4, (13, 11, channels)), 0), 1) % 256
    for img in (rng.integers(0, 256, (13, 11, channels)).astype(np.uint8), smooth.astype(np.uint8),
                rng.integers(0, 256, (5, 17, channels)).astype(np.uint8)):
        for ftype in [*range(5), rng.integers(0, 5, img.shape[0])]:
            p = tmp_path / "filtered.png"
            p.write_bytes(_png_bytes(img, ftype))
            np.testing.assert_array_equal(read_png(p), img[..., 0] if channels == 1 else img)
            np.testing.assert_array_equal(read_png(p), iio.imread(p))
        p = tmp_path / "iio.png"
        iio.imwrite(p, img[..., 0] if channels == 1 else img)
        np.testing.assert_array_equal(read_png(p), iio.imread(p))
        if channels != 2:
            write_png(p, img)
            np.testing.assert_array_equal(iio.imread(p), img[..., 0] if channels == 1 else img)


@pytest.mark.parametrize("shape", [(16, 16), (34, 18), (17, 23)])
def test_area_resize_matches_cv2(shape):
    """The half-res resize against OpenCV's INTER_AREA: exact for even
    sizes (the 2 x 2 box mean), 1e-7 for odd ones (OpenCV rounds its
    fractional weights to float32)."""
    import cv2

    img = np.random.default_rng(0).random(shape + (4,))
    H, W = shape[0] // 2, shape[1] // 2
    ref = cv2.resize(img, (W, H), interpolation=cv2.INTER_AREA)
    tol = 0.0 if shape[0] % 2 == 0 and shape[1] % 2 == 0 else 1e-7
    np.testing.assert_allclose(tparser.resize_area(img, H, W), ref, rtol=0, atol=tol)


def test_make_hints_scene_matches_jax(tmp_path, scene_dir):
    """The same json files, and the same pixels in every PNG."""
    import imageio.v3 as iio

    jdir = jax_make_hints_scene(tmp_path / "jax", *SPLITS.values(), H=16, W=16)
    files = sorted(p.relative_to(scene_dir) for p in scene_dir.rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(jdir) for p in jdir.rglob("*") if p.is_file())
    assert len(files) == 3 + sum(SPLITS.values())
    for f in files:
        if f.suffix == ".json":
            assert (scene_dir / f).read_text() == (jdir / f).read_text()
        else:
            np.testing.assert_array_equal(read_png(scene_dir / f), iio.imread(jdir / f))


# Adam7's passes: (x0, y0, dx, dy) of each pass's sub-image.
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _interlaced_png_bytes(img):
    """An 8-bit RGBA PNG of ``img`` [H, W, 4] uint8 under Adam7 interlacing
    (each pass's rows unfiltered), written here: imageio's PNG writers
    (Pillow, OpenCV) write no interlaced PNG."""
    H, W, _ = img.shape
    rows = b"".join(b"\x00" + row.tobytes() for x0, y0, dx, dy in _ADAM7
                    for row in img[y0::dy, x0::dx] if row.size)

    def chunk(t, d):
        return struct.pack(">I", len(d)) + t + d + struct.pack(">I", zlib.crc32(t + d))

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, 6, 0, 0, 1))
            + chunk(b"IDAT", zlib.compress(rows)) + chunk(b"IEND", b""))


def _rewrite_frames(src, dst, ext: str, intrinsics=None, png=None):
    """A copy of the scene whose frames are ``ext`` files of the same RGBA
    pixels (.npy as floats in [0, 1], .exr as float EXR); with ``png``
    "palette", 16-colour palette PNGs of their RGB (imageio's Pillow writer,
    quantized), with "interlaced" Adam7-interlaced RGBA PNGs."""
    import imageio

    dst.mkdir()
    for split in SPLITS:
        meta = json.loads((src / f"transforms_{split}.json").read_text())
        (dst / split).mkdir()
        for frame in meta["frames"]:
            rgba8 = read_png(src / (frame["file_path"] + ".png"))
            rgba = rgba8 / 255.0
            out = dst / (frame["file_path"] + ext)
            if png == "palette":
                imageio.imwrite(out, rgba8[..., :3], format="PNG-PIL", quantize=16)
            elif png == "interlaced":
                out.write_bytes(_interlaced_png_bytes(rgba8))
            elif ext == ".npy":
                np.save(out, rgba)
            else:
                texr.write_exr(out, rgba, pixel_type="float")
            frame["file_ext"] = ext
        if intrinsics is not None:
            meta["camera_intrinsics"] = intrinsics
        (dst / f"transforms_{split}.json").write_text(json.dumps(meta))
    return dst


@pytest.mark.parametrize("case", ["png", "png-black", "png-half", "npy-intrinsics", "exr", "png-palette",
                                  "png-interlaced"])
def test_parser_matches_jax(tmp_path, scene_dir, case):
    """SceneData arrays and camera equal to JAX's parser's: exact, 1e-6 at
    half_res; palette and interlaced PNGs (read through imageio, as JAX
    reads them) too, the interlaced scene's images equal to the plain
    PNGs'."""
    path = scene_dir
    if case.startswith("npy"):
        path = _rewrite_frames(scene_dir, tmp_path / "npy", ".npy", intrinsics=[7.5, 8.25, 20.0, 21.0])
    elif case == "exr":
        path = _rewrite_frames(scene_dir, tmp_path / "exr", ".exr")
    elif case in ("png-palette", "png-interlaced"):
        path = _rewrite_frames(scene_dir, tmp_path / case, ".png", png=case[4:])
        with pytest.raises(NotImplementedError, match="interlaced" if case == "png-interlaced" else "colour type 3"):
            read_png(path / "train" / "r_0.png")
    kw = dict(half_res=case == "png-half", white_background=case != "png-black")
    t, j = tparser.parse_load_nr_data(path, **kw), jparser.parse_load_nr_data(path, **kw)
    tol = 1e-6 if kw["half_res"] else 0.0
    for k in ("images", "poses", "pls"):
        assert getattr(t, k).dtype == np.float32
        np.testing.assert_allclose(getattr(t, k), getattr(j, k), rtol=0, atol=tol, err_msg=k)
    assert t.camera == type(t.camera)(*j.camera.__dict__.values())
    assert t.num_image_per_split == j.num_image_per_split == list(SPLITS.values())
    assert t.images.shape[1:3] == ((8, 8) if kw["half_res"] else (16, 16))
    if case.startswith("npy"):
        assert (t.camera.cx, t.camera.cy, t.camera.fx, t.camera.fy) == (7.5, 8.25, 20.0, 21.0)
    if case == "png-interlaced":
        np.testing.assert_array_equal(t.images, tparser.parse_load_nr_data(scene_dir).images)


def test_parser_rejects_16bit_png(tmp_path, scene_dir):
    """A 16-bit PNG (read by imageio as uint16) raises, as the port's own
    reader does, where JAX divides it by 255."""
    import shutil

    import imageio.v3 as iio

    path = tmp_path / "png16"
    shutil.copytree(scene_dir, path)
    first = path / "train" / "r_0.png"
    iio.imwrite(first, read_png(first)[..., 0].astype(np.uint16) * 257)  # 16-bit gray
    assert iio.imread(first).dtype == np.uint16
    with pytest.raises(NotImplementedError, match="uint16"):
        tparser.parse_load_nr_data(path)


@pytest.mark.parametrize("compression", ["none", "zips", "zip"])
@pytest.mark.parametrize("pixel_type", ["half", "float"])
def test_exr_matches_jax(tmp_path, compression, pixel_type):
    """Both directions, exact: the port's files are the JAX writer's bytes,
    and each reader decodes the other's file to the same pixels."""
    img = (np.random.default_rng(1).random((37, 13, 4)) * 4.0).astype(np.float32)
    tp, jp = tmp_path / "t.exr", tmp_path / "j.exr"
    texr.write_exr(tp, img, compression=compression, pixel_type=pixel_type)
    jexr.write_exr(jp, img, compression=compression, pixel_type=pixel_type)
    assert tp.read_bytes() == jp.read_bytes()
    np.testing.assert_array_equal(texr.read_exr(jp), jexr.read_exr(jp))
    np.testing.assert_array_equal(jexr.read_exr(tp), texr.read_exr(tp))


def test_video_poses_match_jax():
    """The three pose functions, both up axes: 1e-6."""
    for z_up in (False, True):
        np.testing.assert_allclose(tvp.pose_spherical(30.0, -25.0, 3.3, z_up), jvp.pose_spherical(30.0, -25.0, 3.3, z_up),
                                   atol=1e-6)
        for t, j in zip(tvp.gen_fix_light_rot_view(5, 2.7, [0.0, 1.6, 2.8], is_z_up=z_up),
                        jvp.gen_fix_light_rot_view(5, 2.7, [0.0, 1.6, 2.8], is_z_up=z_up)):
            np.testing.assert_allclose(t, j, atol=1e-6)
        for t, j in zip(tvp.gen_fix_view_rot_light(5, 3.2, view_radius=2.7, is_z_up=z_up),
                        jvp.gen_fix_view_rot_light(5, 3.2, view_radius=2.7, is_z_up=z_up)):
            np.testing.assert_allclose(t, j, atol=1e-6)


def _same_bundle(t, j):
    for f in ("h_indices", "w_indices", "poses", "pls", "img_indices", "rgb_gt"):
        tv, jv = getattr(t, f), getattr(j, f)
        assert (tv is None) == (jv is None), f
        if tv is not None:
            assert isinstance(tv, torch.Tensor) and tv.device.type == "cpu", f
            np.testing.assert_array_equal(tv.numpy(), np.asarray(jv), err_msg=f)


def test_data_manager_matches_jax(scene_dir):
    """Three train batches, a test view and the video bundles: exact."""
    scene = tparser.parse_load_nr_data(scene_dir)
    kw = dict(batch_size=24, image_idx_rng_seed=5, pixel_idx_rng_seed=6)
    t, j = TDM(scene, **kw), JDM(jparser.parse_load_nr_data(scene_dir), **kw)
    for _ in range(3):
        _same_bundle(t.next_train_batch(), j.next_train_batch())
    assert t.test_view_num == j.test_view_num == 2
    _same_bundle(t.get_test_view(1), j.get_test_view(1))
    tv, jv = t.get_video_pixel_bundles(3, is_z_up=True), j.get_video_pixel_bundles(3, is_z_up=True)
    assert tv.shape == jv.shape == (6, 16, 16)
    for i in (0, 4):
        _same_bundle(tv[i], jv[i])
