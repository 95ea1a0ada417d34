"""Run logs (port of ``nrhints_tpu/train/logging.py``): every record goes
to ``metrics.jsonl`` and to one CSV per schema in the run directory (train
metrics to ``metrics.csv``, the ``val/*`` means to ``val_metrics.csv``,
further schemas numbered); a resumed run appends without a second header.
Images go to ``logged_images/`` as PNGs.  wandb mirrors both when asked
for and installed, and is silently skipped otherwise.
"""
from __future__ import annotations

import csv
import json
import pathlib
import time
from typing import Mapping, Optional

import numpy as np

from nrhints_torch.data.png import write_png


class MetricsLogger:
    def __init__(self, run_dir, use_wandb: bool = False, wandb_kwargs: Optional[dict] = None):
        self.run_dir = pathlib.Path(run_dir)
        self.run_dir.mkdir(parents=True, exist_ok=True)
        self._jsonl = open(self.run_dir / "metrics.jsonl", "a", buffering=1)
        self._csv_writers: dict = {}  # schema tuple -> (file, DictWriter)
        self._csv_names: set = set()
        self._wandb = None
        if use_wandb:
            try:
                import wandb

                wandb.init(**(wandb_kwargs or {}))
                self._wandb = wandb
            except Exception:
                self._wandb = None

    def log(self, metrics: Mapping[str, float], step: int) -> None:
        record = {"step": int(step), "ts": time.time()}
        record.update({k: float(v) for k, v in metrics.items()})
        self._jsonl.write(json.dumps(record) + "\n")

        fields = tuple(record.keys())
        entry = self._csv_writers.get(fields)
        if entry is None:
            base = "val_metrics" if any(k.startswith("val/") for k in fields) else "metrics"
            name, i = base, 2
            while name in self._csv_names:
                name, i = f"{base}_{i}", i + 1
            self._csv_names.add(name)
            f = open(self.run_dir / f"{name}.csv", "a", newline="", buffering=1)
            writer = csv.DictWriter(f, fieldnames=fields, extrasaction="ignore")
            if f.tell() == 0:  # no second header when resuming into a file
                writer.writeheader()
            entry = (f, writer)
            self._csv_writers[fields] = entry
        entry[1].writerow(record)

        if self._wandb is not None:
            self._wandb.log(dict(metrics), step=step)

    def log_image(self, name: str, image, step: int) -> None:
        """The image to disk; to wandb too when it is on."""
        img_dir = self.run_dir / "logged_images"
        img_dir.mkdir(exist_ok=True)
        arr = np.asarray(image)
        if arr.ndim == 3 and arr.shape[-1] == 1:
            arr = arr[..., 0]
        if arr.dtype != np.uint8:
            arr = (np.clip(arr, 0, 1) * 255).astype(np.uint8)
        write_png(img_dir / f"{name}_step_{step:07d}.png", arr)
        if self._wandb is not None:
            self._wandb.log({name: self._wandb.Image(arr)}, step=step)

    def close(self) -> None:
        self._jsonl.close()
        for f, _ in self._csv_writers.values():
            f.close()
        self._csv_writers.clear()
        if self._wandb is not None:
            self._wandb.finish()
