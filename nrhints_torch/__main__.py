"""Train a scene: ``python -m nrhints_torch [config:<preset>] --config.<path> <value> ...``

The port's counterpart of the JAX package's ``main.py``, with the same
presets and flag spellings, e.g.

    python -m nrhints_torch config:nr-hints-cam-opt --config.data.path /data/Cup_Plane --config.scene-name cup

It trains on every visible CUDA card, one process a card that it starts
itself (``--config.parallel.data-axis-size N`` for N of them), or, under
torchrun, as the rank torchrun starts it as (across hosts: torchrun on each
host with ``--config.parallel.multihost True``).  It logs, checkpoints and
resumes from the run directory's newest checkpoint, then writes the final
mesh and registers, renders and scores the test views.
"""
from __future__ import annotations

from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None, *, device="cuda"):
    """Parse ``argv`` (``sys.argv[1:]`` when None), train, and return the
    trainer (None where the ranks ran in worker processes)."""
    from nrhints_torch.configs.cli import parse_cli
    from nrhints_torch.configs.config import DEFAULT_PRESET, PRESETS
    from nrhints_torch.train.trainer import launch

    return launch(parse_cli(PRESETS, DEFAULT_PRESET, argv), device=device)


if __name__ == "__main__":
    main()
