"""Data manager (port of ``nrhints_tpu/data/manager.py``): training pixel
batches, whole-image test views and the procedural video views, assembled
on the host from the scene's numpy arrays.

Batches are the JAX package's for the same seeds (``PixelSampler``'s two
numpy streams), handed out as ``PixelBundle``s of CPU tensors; the trainer
copies each to the card.  Image indices are int64, PyTorch's index type.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from nrhints_torch.camera.video_poses import gen_fix_light_rot_view, gen_fix_view_rot_light
from nrhints_torch.core.structs import PixelBundle
from nrhints_torch.data.parser import SceneData
from nrhints_torch.data.sampler import PixelSampler, PixelSamplingStrategy


@dataclass(frozen=True)
class DataManagerConfig:
    path: str = ""
    white_background: bool = True
    half_res: bool = False
    view_num_limit: Optional[int] = None
    testset_skip: int = 8
    video_frame_num: int = 60
    is_z_up: bool = False
    pixel_sampling_strategy: PixelSamplingStrategy = PixelSamplingStrategy.ALL_IMAGES


def _bundle(**fields) -> PixelBundle:
    return PixelBundle(**{k: None if v is None else torch.from_numpy(np.ascontiguousarray(v))
                          for k, v in fields.items()})


def _full_view(pose: np.ndarray, pl: np.ndarray, H: int, W: int, img_idx=None, rgb_gt=None) -> PixelBundle:
    """The [H, W] pixel grid of one view under one pose and light."""
    h_idx, w_idx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    return _bundle(
        h_indices=h_idx.astype(np.float32),
        w_indices=w_idx.astype(np.float32),
        poses=np.broadcast_to(pose, (H, W, 4, 4)),
        pls=np.broadcast_to(pl, (H, W, 3)),
        img_indices=None if img_idx is None else np.full((H, W), img_idx, dtype=np.int64),
        rgb_gt=rgb_gt,
    )


class VideoPixelBundles:
    """Whole-image bundles of the procedural video views, built per frame."""

    def __init__(self, video_poses: np.ndarray, video_pls: np.ndarray, H: int, W: int):
        self.video_poses = video_poses
        self.video_pls = video_pls
        self.H, self.W = H, W

    def __len__(self):
        return len(self.video_poses)

    @property
    def shape(self):
        return (len(self), self.H, self.W)

    def __getitem__(self, idx: int) -> PixelBundle:
        return _full_view(self.video_poses[idx], self.video_pls[idx], self.H, self.W)


class DataManager:
    def __init__(
        self,
        scene: SceneData,
        batch_size: int,
        strategy: PixelSamplingStrategy = PixelSamplingStrategy.ALL_IMAGES,
        training_view_num_limit: Optional[int] = None,
        image_idx_rng_seed: int = 42,
        pixel_idx_rng_seed: int = 42,
        local_rank: int = 0,
    ):
        self.scene = scene
        train_image_num = (
            scene.num_image_per_split[0] if training_view_num_limit is None else training_view_num_limit
        )
        self.sampler = PixelSampler(
            train_image_num=train_image_num,
            H=scene.camera.H,
            W=scene.camera.W,
            batch_size=batch_size,
            image_idx_rng_seed=image_idx_rng_seed,
            pixel_idx_rng_seed=pixel_idx_rng_seed,
            local_rank=local_rank,
            strategy=strategy,
        )

    def next_train_batch(self) -> PixelBundle:
        """A flat [B] batch of pixels (CPU tensors)."""
        s = self.sampler.sample_batch()
        sc = self.scene
        return _bundle(
            h_indices=s.h_indices.astype(np.float32),
            w_indices=s.w_indices.astype(np.float32),
            poses=sc.poses[s.img_indices],
            pls=sc.pls[s.img_indices],
            img_indices=s.img_indices.astype(np.int64),
            rgb_gt=sc.images[s.img_indices, s.h_indices, s.w_indices],
        )

    @property
    def test_view_num(self) -> int:
        return self.scene.num_image_per_split[2]

    def get_test_view(self, idx: int) -> PixelBundle:
        idx += self.scene.num_image_per_split[0] + self.scene.num_image_per_split[1]
        return self.get_view(idx)

    def get_view(self, idx: int) -> PixelBundle:
        sc = self.scene
        return _full_view(sc.poses[idx], sc.pls[idx], sc.camera.H, sc.camera.W, img_idx=idx, rgb_gt=sc.images[idx])

    def get_video_pixel_bundles(self, frame_num: int, is_z_up: bool = False) -> VideoPixelBundles:
        """Two turntable clips with radii from the scene's mean camera and
        light distances."""
        sc = self.scene
        pls_avg_dist = float(np.mean(np.linalg.norm(sc.pls, axis=-1)))
        eye_avg_dist = float(np.mean(np.linalg.norm(sc.poses[..., :3, -1], axis=-1)))
        poses0, pls0 = gen_fix_light_rot_view(
            frame_num, eye_avg_dist, [0.0, 0.5 * pls_avg_dist, 0.866 * pls_avg_dist], is_z_up=is_z_up
        )
        poses1, pls1 = gen_fix_view_rot_light(
            frame_num, pls_avg_dist, [25.0, 25.0, 25.0], -180.0, -30.0, view_radius=eye_avg_dist, is_z_up=is_z_up
        )
        video_poses = np.concatenate([poses0, poses1], axis=0)
        video_pls = np.concatenate([pls0[..., :3], pls1[..., :3]], axis=0)
        return VideoPixelBundles(video_poses, video_pls, sc.camera.H, sc.camera.W)
