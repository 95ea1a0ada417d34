"""Pixel (ray) sampling (port of ``nrhints_tpu/data/sampler.py``, numpy
only): two independent ``np.random.default_rng`` streams (image index,
pixel index) with the same seeds and draws as the JAX package.  The pixel
seed always gets the process rank added; the image seed only under
ALL_IMAGES (under SAME_IMAGE every process picks the same image).  Stream
states are checkpointable for bit-exact resume.
"""
from __future__ import annotations

from dataclasses import dataclass
from enum import Enum

import numpy as np


class PixelSamplingStrategy(str, Enum):
    ALL_IMAGES = "all_images"
    SAME_IMAGE = "same_image"


@dataclass
class SampledIndices:
    img_indices: np.ndarray  # [B] int
    h_indices: np.ndarray  # [B] int
    w_indices: np.ndarray  # [B] int


class PixelSampler:
    def __init__(
        self,
        train_image_num: int,
        H: int,
        W: int,
        batch_size: int,
        image_idx_rng_seed: int = 42,
        pixel_idx_rng_seed: int = 42,
        local_rank: int = 0,
        strategy: PixelSamplingStrategy = PixelSamplingStrategy.ALL_IMAGES,
    ):
        self.batch_size = batch_size
        self.train_image_num = train_image_num
        self.H, self.W = H, W
        self.strategy = strategy
        if strategy == PixelSamplingStrategy.ALL_IMAGES:
            image_idx_rng_seed += local_rank
        pixel_idx_rng_seed += local_rank
        self.image_rng = np.random.default_rng(seed=image_idx_rng_seed)
        self.pixel_rng = np.random.default_rng(seed=pixel_idx_rng_seed)

    def sample_batch(self) -> SampledIndices:
        if self.strategy == PixelSamplingStrategy.ALL_IMAGES:
            img_indices = self.image_rng.choice(self.train_image_num, self.batch_size)
        elif self.strategy == PixelSamplingStrategy.SAME_IMAGE:
            img_indices = np.repeat(
                self.image_rng.choice(self.train_image_num, 1), self.batch_size
            )
        else:
            raise NotImplementedError(self.strategy)
        h_indices = self.pixel_rng.choice(self.H, self.batch_size)
        w_indices = self.pixel_rng.choice(self.W, self.batch_size)
        return SampledIndices(img_indices, h_indices, w_indices)

    # -- checkpointable RNG state ------------------------------------------

    def get_state(self) -> dict:
        return {
            "image": self.image_rng.bit_generator.state,
            "pixel": self.pixel_rng.bit_generator.state,
        }

    def set_state(self, state: dict) -> None:
        self.image_rng.bit_generator.state = state["image"]
        self.pixel_rng.bit_generator.state = state["pixel"]
