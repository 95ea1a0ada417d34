"""nrhints-torch: the NRHints relighting renderer in PyTorch, with its
kernels hand-written in CUDA C++ for Hopper (``sm_90a``).

A port of ``nrhints_tpu`` (JAX/Pallas on TPU).  The layout mirrors the JAX
package module for module, so ``nrhints_torch/fields/sdf.py`` is the
counterpart of ``nrhints_tpu/fields/sdf.py``.  This package imports torch
and numpy only.

Slice 1 ported the whole-image relighting render (``eval/evaluator.py``
down to kernels A, B and C), slice 2 the train step under the stash
backward (kernels D-G), and slice 3 the recompute backward schedule
(``core_backward="recompute"``: kernels H, I, J), ``"stash_xla"``, and the
fused eval trunk (``eval_reflectance_impl="pallas"``: kernel I), slice 4
the round-4 march (kernels K-N); later slices the training entry point,
``python -m nrhints_torch`` (``__main__.py``: the scene parser, the
trainer with its logs and checkpoints, test-view registration and
metrics, the mesh and the video), and data parallelism over ranks, one
process a card (``parallel/mesh.py``).  Entry
points and the functions that build the model state (``init_model_params``,
``ray_generator_init``, ``params_from_jax``) run on the CUDA device unless
the caller passes ``device="cpu"``, and raise without CUDA; on the CPU every
kernel wrapper runs its plain PyTorch version instead.
"""

__version__ = "0.1.0"
