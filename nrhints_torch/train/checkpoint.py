"""Checkpoints and resume (port of ``nrhints_tpu/train/checkpoint.py``,
``torch.save`` in place of orbax, the same layout):

* ``ckpt/step_XXXXXXX/state.pt`` every N steps, with ``meta.json`` holding
  the world size as the JAX package counts it (hosts: ``world_size``) and
  the ranks (``ranks``);
* ``rng_state/step_XXXXXXX_host_{h}.pickle``: host h's random state (the
  pixel sampler's streams), restored tolerantly: a failure warns;
* resume from an explicit path, or else the newest checkpoint, falling back
  to the previous one when the newest does not load.

Under data parallelism the Trainer hands the state to rank 0 alone, and
each host's first rank its sidecar.

The state is whatever dict of tensors and numbers the trainer hands over
(its params, Adam's moments and step, the raygen buffers); it loads onto
the CPU and the trainer copies it into its live tensors.
"""
from __future__ import annotations

import json
import pathlib
import pickle
import re
import warnings
from typing import Any, Optional, Tuple

import torch

_STEP_RE = re.compile(r"step_(\d+)$")
STATE_FILE = "state.pt"


class CheckpointIO:
    def __init__(self, run_dir):
        self.run_dir = pathlib.Path(run_dir)
        self.ckpt_dir = self.run_dir / "ckpt"
        self.rng_dir = self.run_dir / "rng_state"
        self.ckpt_dir.mkdir(parents=True, exist_ok=True)
        self.rng_dir.mkdir(parents=True, exist_ok=True)

    def save(self, step: int, state: Optional[dict], rng_sidecar: Optional[dict] = None,
             world_size: Optional[int] = None, *, host_index: int = 0, ranks: Optional[int] = None) -> None:
        """``state`` (None: none written) and its ``meta.json`` with
        ``world_size``, the host count, and ``ranks`` (default: one a host);
        ``rng_sidecar`` as host ``host_index``'s."""
        if state is not None:
            path = self.ckpt_dir / f"step_{step:07d}"
            path.mkdir(parents=True, exist_ok=True)
            tmp = path / (STATE_FILE + ".tmp")
            torch.save(state, tmp)
            tmp.replace(path / STATE_FILE)
            if world_size is not None:
                meta = {"world_size": world_size, "ranks": world_size if ranks is None else ranks}
                (path / "meta.json").write_text(json.dumps(meta))
        if rng_sidecar is not None:
            with open(self._sidecar(step, host_index), "wb") as f:
                pickle.dump(rng_sidecar, f)

    def _sidecar(self, step: int, host_index: int) -> pathlib.Path:
        return self.rng_dir / f"step_{step:07d}_host_{host_index}.pickle"

    def available_steps(self) -> list[int]:
        steps = []
        for p in self.ckpt_dir.iterdir() if self.ckpt_dir.exists() else []:
            m = _STEP_RE.search(p.name)
            if m and p.is_dir():
                steps.append(int(m.group(1)))
        return sorted(steps)

    def load_newest(self, explicit_path: Optional[str] = None) -> Tuple[Optional[Any], Optional[int]]:
        """(state, step) of an explicit checkpoint directory, or of the
        newest one that loads; (None, None) when none does."""
        if explicit_path is not None:
            candidates = [pathlib.Path(explicit_path)]
        else:
            candidates = [self.ckpt_dir / f"step_{s:07d}" for s in reversed(self.available_steps())]
        for i, path in enumerate(candidates):
            try:
                state = torch.load(path / STATE_FILE, map_location="cpu", weights_only=True)
                m = _STEP_RE.search(path.name)
                return state, int(m.group(1)) if m else None
            except Exception as e:  # a corrupted or partial checkpoint
                if i + 1 < len(candidates):
                    warnings.warn(f"checkpoint {path} failed to load ({e!r}); falling back to {candidates[i + 1]}")
                    continue
                warnings.warn(f"no loadable checkpoint found (last error: {e!r})")
        return None, None

    def load_rng_sidecar(self, step: int, host_index: int = 0) -> Optional[dict]:
        try:
            with open(self._sidecar(step, host_index), "rb") as f:
                return pickle.load(f)
        except Exception as e:
            warnings.warn(f"rng state resume failed ({e!r}); results may not be fully reproducible")
            return None

    def load_world_size(self, step: int) -> Optional[int]:
        """The host count a checkpoint was written at (None if unrecorded)."""
        path = self.ckpt_dir / f"step_{step:07d}" / "meta.json"
        try:
            return int(json.loads(path.read_text())["world_size"])
        except Exception:
            return None
