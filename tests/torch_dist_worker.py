"""Rank bodies of tests/test_torch_parallel.py, one spawned process a rank.

This module imports torch and nrhints_torch only (never JAX), so a rank
starts fast.  ``start_ranks`` spawns ``world`` processes
(``torch.multiprocessing``, spawn); each takes 2 threads, joins a gloo
group through a ``file://`` rendezvous in its output directory with an
explicit timeout, runs one body and ``torch.save``s what the body returns
to ``out_dir/rank{r}.pt``; ``join_ranks`` waits, with a deadline, and
loads those files.
"""
from __future__ import annotations

import dataclasses
import os
import pathlib
import shutil
import time
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

GROUP_TIMEOUT = timedelta(seconds=120)


def start_ranks(body: str, world: int, out_dir, *args):
    """Spawn ``world`` ranks of ``body`` (a function of this module named
    by a string) -> the process context for ``join_ranks``."""
    out_dir = pathlib.Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    return torch.multiprocessing.start_processes(
        _rank_entry, args=(body, world, str(out_dir), args), nprocs=world, join=False, start_method="spawn")


def join_ranks(ctx, out_dir, timeout: float = 240.0) -> list:
    """Wait for the ranks (raising if one fails, or if they outlive
    ``timeout`` seconds) -> each rank's result, in rank order."""
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=5.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"the ranks did not finish in {timeout} s")
    out_dir = pathlib.Path(out_dir)
    return [torch.load(out_dir / f"rank{r}.pt", weights_only=False) for r in range(len(ctx.processes))]


def _rank_entry(rank: int, body: str, world: int, out_dir: str, args: tuple) -> None:
    from nrhints_torch.parallel.mesh import initialize_multihost

    torch.set_num_threads(2)
    out = pathlib.Path(out_dir)
    initialize_multihost(f"file://{out / 'rendezvous'}", rank, world, device="cpu", timeout=GROUP_TIMEOUT)
    try:
        result = globals()[body](rank, world, out, *args)
        torch.save(result, out / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _tensors(tree: dict) -> dict:
    return {k: torch.as_tensor(np.array(v)) for k, v in tree.items()}


def _snapshot(state) -> dict:
    """Params, Adam's moments and step of every leaf, by path."""
    from nrhints_torch.utils import tree_items

    out = {}
    for name, t in tree_items(state.params):
        out[name] = t.detach().clone()
        for k, v in state.optimizer.state.get(t, {}).items():
            out[f"{name} {k}"] = v.detach().clone()
    return out


def steps_body(rank: int, world: int, out_dir, payload: dict) -> dict:
    """The data-parallel train step on this rank's rows of ``payload``'s
    global batches: (a) two single steps handed JAX's global uniforms by
    rows, each step's gradients and metrics kept; (b) two single steps
    and (c) one K = 2 scan, both drawing their jitter from per-step
    generators, from the same start."""
    from nrhints_torch.convert import params_from_jax
    from nrhints_torch.core.structs import PixelBundle
    from nrhints_torch.parallel.mesh import make_mesh, rank_rows, shard_batch
    from nrhints_torch.train import step as tstep
    from nrhints_torch.utils import tree_items

    cfg, cam = payload["cfg"], payload["camera"]
    mesh = make_mesh(world)
    batches = [shard_batch(mesh, PixelBundle(**_tensors(b))) for b in payload["batches"]]

    def fresh():
        params = params_from_jax(payload["params"], device="cpu")
        return tstep.init_train_state(params, tstep.make_optimizer(cfg, params))

    state = fresh()
    step_fn = tstep.make_train_step(cfg, cam, {}, state.optimizer, mesh=mesh)
    jax_steps = []
    for b, u in zip(batches, payload["uniforms"]):
        rows = rank_rows(mesh, b.h_indices.shape[0])
        state, metrics = step_fn(state, b, uniforms={k: torch.as_tensor(v)[rows] for k, v in u.items()})
        grads = {name: t.grad.detach().clone() for name, t in tree_items(state.params)}
        jax_steps.append({"metrics": metrics, "grads": grads})
    out = {"jax_uniforms": {"steps": jax_steps, "state": _snapshot(state),
                            "optimizer": state.optimizer.state_dict()}}

    state = fresh()
    step_fn = tstep.make_train_step(cfg, cam, {}, state.optimizer, mesh=mesh)
    for i, b in enumerate(batches):
        state, metrics = step_fn(state, b, torch.Generator().manual_seed(100 + i))
    out["single"] = {"state": _snapshot(state), "metrics": metrics}

    state = fresh()
    scan = tstep.make_train_step_scan(cfg, cam, {}, state.optimizer, n_steps=len(batches), mesh=mesh)
    state, metrics = scan(state, tstep.stack_bundles(batches),
                          [torch.Generator().manual_seed(100 + i) for i in range(len(batches))])
    out["scan"] = {"state": _snapshot(state), "metrics": metrics}
    return out


class _Spy:
    """Record the calls of ``cls.name`` (their arguments, through ``keep``)
    while the rank runs."""

    def __init__(self, cls, name: str, keep):
        self.calls = []
        orig = getattr(cls, name)

        def wrapped(*args, **kwargs):
            self.calls.append(keep(*args, **kwargs))
            return orig(*args, **kwargs)

        setattr(cls, name, wrapped)


def _record_batches(trainer, seen: list) -> None:
    """Keep every batch the trainer's single steps take (this rank's rows)."""
    for attr in ("_step_normal", "_step_warmup"):
        fn = getattr(trainer, attr)
        if fn is None:
            continue

        def rec(state, batch, generator=None, uniforms=None, _fn=fn):
            seen.append({f.name: getattr(batch, f.name).clone() for f in dataclasses.fields(batch)})
            return _fn(state, batch, generator, uniforms)

        setattr(trainer, attr, rec)


def trainer_body(rank: int, world: int, out_dir, cfg, reg_steps: int) -> dict:
    """The Trainer at two ranks on the scene on disk, registration cut to
    ``reg_steps`` steps a view:

    * ``w2``: one host of two ranks runs ``cfg`` (checkpoints, the video,
      the final mesh and test views), its batches and its calls to the
      logger and the checkpoint kept;
    * ``w2b``: the step-2 checkpoint copied to a new run, resumed to the end;
    * ``scaled``: ``scale_global_batch``, one step; ``multihost``: the
      group already joined, one step;
    * ``hosts``: two hosts of one rank each (torchrun's LOCAL_WORLD_SIZE=1,
      LOCAL_RANK=0), two steps and a checkpoint."""
    from nrhints_torch.eval.evaluator import Evaluator
    from nrhints_torch.parallel.mesh import barrier
    from nrhints_torch.train import trainer as ttrainer
    from nrhints_torch.train.checkpoint import CheckpointIO
    from nrhints_torch.utils import tree_items

    register = Evaluator.register_view
    Evaluator.register_view = lambda self, p, px, steps=500, pixel_draws=None: register(self, p, px, reg_steps)
    saves = _Spy(CheckpointIO, "save", lambda io, step, state, rng_sidecar=None, world_size=None, host_index=0,
                 ranks=None: {"step": step, "state": state is not None, "sidecar": rng_sidecar is not None,
                              "host_index": host_index})
    means = []
    tests = ttrainer.Trainer.render_test_views

    def spy_views(self, is_final=False):
        means.append(tests(self, is_final))
        return means[-1]

    ttrainer.Trainer.render_test_views = spy_views
    out = {}

    def run(name, c, final=True):
        t = ttrainer.Trainer(dataclasses.replace(c, base_dir=str(out_dir / name)), device="cpu")
        seen = []
        _record_batches(t, seen)
        if not final:
            t.dump_mesh = lambda resolution=256: None
            t.render_test_views = lambda is_final=False: {}
        t.run()
        return t, seen

    t, seen = run("w2", cfg)
    out["w2"] = {"batches": seen, "means": means[-1], "logger": t.logger is not None, "saves": saves.calls[:],
                 "raygen": {k: v.detach().clone() for k, v in t.state.params["raygen"].items()},
                 "mesh": (t.mesh.rank, t.mesh.world_size, t.mesh.host_index, t.mesh.host_count),
                 "global_batch": (t.global_batch, t.local_batch)}

    if rank == 0:
        src, dst = t.log_dir, out_dir / "w2b" / t.log_dir.relative_to(out_dir / "w2")
        shutil.copytree(src / "ckpt" / "step_0000002", dst / "ckpt" / "step_0000002")
        (dst / "rng_state").mkdir(parents=True)
        shutil.copy(src / "rng_state" / "step_0000002_host_0.pickle", dst / "rng_state")
    barrier(t.mesh)
    t, seen = run("w2b", cfg, final=False)
    out["w2b"] = {"steps_run": len(seen), "global_step": t.global_step}

    par = cfg.parallel
    t = ttrainer.Trainer(dataclasses.replace(cfg, base_dir=str(out_dir / "scaled"), parallel=dataclasses.replace(
        par, scale_global_batch=True)), device="cpu")
    out["scaled"] = {"global_batch": (t.global_batch, t.local_batch),
                     "base_lr": [g["base_lr"] for g in t.optimizer.param_groups],
                     "loss": float(t.train_iter()["loss"])}
    t = ttrainer.Trainer(dataclasses.replace(cfg, base_dir=str(out_dir / "mh"), parallel=dataclasses.replace(
        par, multihost=True)), device="cpu")
    out["multihost"] = {"mesh": (t.mesh.rank, t.mesh.world_size, t.mesh.backend), "loss": float(t.train_iter()["loss"])}

    os.environ["LOCAL_WORLD_SIZE"], os.environ["LOCAL_RANK"] = "1", "0"
    n_saves = len(saves.calls)
    t, seen = run("hosts", dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, end_iter=2)), final=False)
    out["hosts"] = {"batches": seen, "saves": saves.calls[n_saves:],
                    "mesh": (t.mesh.rank, t.mesh.world_size, t.mesh.host_index, t.mesh.host_count),
                    "params": {n: p.detach().clone() for n, p in tree_items(t.state.params)}}
    return out


def grid_marches_body(rank: int, world: int, out_dir, payload: dict) -> dict:
    """The marches on a 1 x ``world`` ('data', 'sample') grid, every rank
    holding the same rays: the sample-sharded shadow and importance marches
    of ``payload["cfg_off"]`` (fused_kernels="off") on the ``sharded``
    rays, and the fused route of ``payload["cfg_on"]`` flatten-sharded over
    the group on the ``fused`` rays (their count divides the group), each
    beside the same march with no mesh; the rows each fused call took."""
    from nrhints_torch.convert import params_from_jax
    from nrhints_torch.parallel.mesh import make_mesh
    from nrhints_torch.render import renderer as tr

    mesh = make_mesh(sample_axis_size=world)
    params = params_from_jax(payload["params"], device="cpu")
    calls = []
    for name in ("fused_importance_z", "fused_shadow_tau"):
        orig = getattr(tr, name)

        def rec(*a, _orig=orig, _name=name, **kw):
            calls.append((_name, int(a[3].shape[0])))
            return _orig(*a, **kw)

        setattr(tr, name, rec)
    out = {"mesh": (mesh.rank, mesh.world_size, mesh.data_size, mesh.data_index, mesh.sample_index)}
    for key, cfg in (("sharded", payload["cfg_off"]), ("fused", payload["cfg_on"])):
        pls, tp, o, d, z0 = (torch.as_tensor(a) for a in payload[key])
        with torch.no_grad():
            for m, tag in ((mesh, ""), (None, "_ref")):
                out[f"{key}_tau{tag}"] = tr._shadow_transmittance(params, cfg, pls, tp, 1.0, None, m)
                out[f"{key}_z{tag}"] = tr._importance_sample_z(params, cfg, o, d, z0, m)
    out["calls"] = calls
    return out


def grid_step_body(rank: int, world: int, out_dir, payload: dict) -> dict:
    """One train step on a 1 x ``world`` grid, every rank on the whole
    batch with JAX's global uniforms: the metrics, every leaf's gradient
    and the params after the step."""
    from nrhints_torch.convert import params_from_jax
    from nrhints_torch.core.structs import PixelBundle
    from nrhints_torch.parallel.mesh import make_mesh
    from nrhints_torch.train import step as tstep
    from nrhints_torch.utils import tree_items

    cfg = payload["cfg"]
    mesh = make_mesh(sample_axis_size=world)
    params = params_from_jax(payload["params"], device="cpu")
    state = tstep.init_train_state(params, tstep.make_optimizer(cfg, params))
    step_fn = tstep.make_train_step(cfg, payload["camera"], {}, state.optimizer, mesh=mesh)
    u = {k: torch.as_tensor(v) for k, v in payload["uniforms"].items()}
    state, metrics = step_fn(state, PixelBundle(**_tensors(payload["batch"])), uniforms=u)
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": {n: t.grad.detach().clone() for n, t in tree_items(state.params)},
            "params": {n: t.detach().clone() for n, t in tree_items(state.params)}}
