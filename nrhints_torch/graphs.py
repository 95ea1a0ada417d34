"""CUDA graphs of the port's three hot loops: the K-step train dispatch
(``train/step.py::make_train_step_scan``), a test view's registration step
(``Evaluator.register_view``) and a view's chunk sweep
(``Evaluator.render_image_async``).  The JAX package runs each as one
dispatch (``lax.scan`` or one jit); here each is captured once and replayed.

The recipe every caller follows:

* every value that changes between replays lives in a device tensor that
  is filled before the replay (batches, jitter uniforms, learning rates,
  cos_anneal_ratio, poses, parameters); nothing inside the captured code
  reads a host value that changes;
* the first call of a key runs the same code eagerly on a side stream
  (``warm_up``): it builds and loads the kernels, creates the cuBLAS
  handles and Adam's state, and its result is the call's result; only then
  is the code captured, and later calls replay it;
* every tensor read after a replay is cloned before any other graph of the
  same pool replays, so the graphs of one owner may share one memory pool
  (they never run at once);
* a capture launches nothing, so ``Graph.capture`` takes back the launch
  counts its wrappers added, and every ``replay`` adds them again:
  ``cuda_lib.launch_counts`` counts the kernels that ran;
* in a process of a ``torch.distributed`` group, a capture refuses unsafe
  calls of its own thread only (``capture_error_mode="thread_local"``):
  NCCL's watchdog thread queries the events of earlier collectives, and
  those queries must not end the capture.  A K-step train graph under
  NCCL holds its collectives; the group's communicator is made before
  the first capture (``parallel/mesh.py::initialize_multihost``).

A capture or a replay that fails raises; nothing falls back to the eager
loop.
"""
from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist

from nrhints_torch.kernels import cuda_lib


def warm_up(fn: Callable[[], Any]) -> Any:
    """``fn()`` on a side stream that waits for the current one and is
    waited for after it (PyTorch's warm-up before a capture).  The tensors
    it returns are marked as used on the current stream, so their memory is
    not reused before the current stream is done with them."""
    cur = torch.cuda.current_stream()
    side = torch.cuda.Stream()
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        out = fn()
    cur.wait_stream(side)
    _record(out, cur)
    return out


def _record(tree, stream) -> None:
    if isinstance(tree, torch.Tensor):
        tree.record_stream(stream)
    elif isinstance(tree, dict):
        for v in tree.values():
            _record(v, stream)


class Graph:
    """One ``torch.cuda.CUDAGraph`` and the kernel launches of its capture.
    ``pool``: a ``torch.cuda.graph_pool_handle()`` shared with the owner's
    other graphs, or None for a private pool."""

    def __init__(self, pool=None):
        self.graph = torch.cuda.CUDAGraph()
        self.pool = pool
        self.launches: dict[str, int] = {}

    def capture(self, fn: Callable[[], Any]) -> Any:
        """Capture ``fn()`` -> its outputs (tensors the replays rewrite)."""
        before = dict(cuda_lib.launch_counts)
        mode = "thread_local" if dist.is_initialized() else "global"
        with torch.cuda.graph(self.graph, pool=self.pool, capture_error_mode=mode):
            out = fn()
        self.launches = {k: cuda_lib.launch_counts[k] - before[k] for k in before}
        for k, v in self.launches.items():
            cuda_lib.launch_counts[k] -= v
        return out

    def replay(self) -> None:
        self.graph.replay()
        for k, v in self.launches.items():
            cuda_lib.launch_counts[k] += v


def copy_tree_(dst, src) -> None:
    """Copy a nested dict of tensors into one of the same structure, in
    place and without autograd."""
    with torch.no_grad():
        if isinstance(dst, dict):
            if sorted(dst) != sorted(src):
                raise ValueError(f"tree keys {sorted(src)} do not match {sorted(dst)}")
            for k in dst:
                copy_tree_(dst[k], src[k])
        else:
            dst.copy_(src)

