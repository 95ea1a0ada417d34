#!/usr/bin/env python3
"""Where a 64-ray train step's gradients on the card part from the CPU's.

    python3 scripts/probe_card_cpu_grads.py [D_HIDDEN ...]   (default: 256 512 1024)

For each SDF width, ``nr-hints-cam-opt`` with that ``sdf_network.d_hidden``
and ``shadow_final_impl="xla"`` (chip_smoke.py phase 23's routes: every
march "xla"), from a seed-0 state after one eager step on the card, runs
chip_smoke.py's 64-ray step (phase 23(b)'s batches, pixels and uniforms)
five ways:

  kernels  on the card through the CUDA kernels (D, E, F, G and B);
  plain    on the card with the SDF core's and the trunk's kernels (D, E,
           F, G) replaced by their plain versions, the code the CPU runs,
           on the card's tensors (so only the summation order of the
           products differs from the CPU: cuBLAS against the CPU's BLAS);
  core     on the card with only the SDF core's kernels (D, E) replaced;
  trunk    on the card with only the trunk's kernels (F, G) replaced;
  shuffled "plain", with kernel D's error on the feature (its feature
           less plain D's, on the step's first call) added to plain D's
           feature with the points shuffled: an error of the same sizes
           that D's arithmetic did not make at those points;
  cpu      on the CPU, every plain version.

and prints, for each pair, the loss of both and the worst leaves by
chip_smoke.py's measure (|a - b| max over the leaf's |b| max), with the
relative norm of the same error.  Where "plain vs cpu" reads as high as
"kernels vs cpu", the step itself carries that much of the summation
order, not the kernels; "kernels vs core" is what D and E alone move,
"kernels vs trunk" what F and G alone move, and "shuffled vs plain" what
any error of kernel D's sizes moves (the trunk's sensitivity, where "kernels
vs plain" reads as high, rather than a fault of D).  It also prints the feature
D hands the trunk, kernel D's and plain D's (both bf16 dot operands)
against plain D's at f32 dot operands on the same points (max and mean
over scale, relative norm), and how many of the trunk's pre-activations z_i change sign
between the kernels' step and the plain step (the ReLU masks they flip).
It needs one card; it imports no JAX.
"""
from __future__ import annotations

import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def plain_on_card(core: bool = True, trunk: bool = True, record: dict | None = None, feat_error=None):
    """Context that swaps core_stash's card wrappers of D and E (``core``)
    and of F and G (``trunk``) for their plain versions on the same tensors
    (the stashes packed as the kernels pack them).  ``record``: a dict that
    gets the feature D (or its plain version) returned and the trunk's
    pre-activations F (or its plain version) stashed, each call's.
    ``feat_error``: added to the feature of D's first call."""
    import contextlib

    import torch

    from nrhints_torch.kernels import core_stash as cs
    from nrhints_torch.kernels.common import torch_dtype

    def sdf_fwd(weights, x, cfg, pk=None, stash_us=False, compute_dtype="bfloat16", stash_dtype="bfloat16"):
        out = cs.sdf_core_fwd_hs_plain(weights, x, cfg, compute_dtype, stash_dtype, return_us=stash_us)
        parts = [*out[3], *out[4], out[5]] if stash_us else out[3]
        packed = torch.zeros((x.shape[0], cs.sdf_stash_width(cfg, stash_us)), dtype=torch_dtype(stash_dtype),
                             device=x.device)
        for (off, w), p in zip(cs.sdf_stash_columns(cfg, stash_us), parts):
            packed[:, off : off + w] = p
        return out[0], out[1], out[2], packed

    def sdf_bwd(weights, x, stash, cots, cfg, pk=None, need_dw=True, stash_us=False, compute_dtype="bfloat16",
                stash_dtype="bfloat16"):
        parts = cs.split_stash(stash, cs.sdf_stash_columns(cfg, stash_us))
        L = cfg.n_layers
        if stash_us:
            return cs.sdf_core_bwd_stash_all_plain(weights, x, parts[:L], parts[L : 2 * L], parts[2 * L], cots, cfg,
                                                   compute_dtype, need_dw)
        return cs.sdf_core_bwd_stash_plain(weights, x, parts, cots, cfg, compute_dtype, need_dw)

    def mlp_fwd(weights, x, n_layers, pk=None, compute_dtype="bfloat16", stash_dtype="bfloat16"):
        out, zs = cs.mlp_relu_fwd_zs_plain(weights, x, n_layers, compute_dtype, stash_dtype)
        return out, torch.cat(zs, dim=-1)

    def mlp_bwd(weights, x, zs, g, n_layers, pk=None, compute_dtype="bfloat16", stash_dtype="bfloat16"):
        widths = [weights[2 * i].shape[1] for i in range(n_layers)]
        return cs.mlp_relu_bwd_stash_plain(weights, x, list(torch.split(zs, widths, dim=-1)), g, n_layers,
                                           compute_dtype)

    saved = (cs.sdf_stash_fwd, cs.sdf_stash_bwd, cs.mlp_stash_fwd, cs.mlp_stash_bwd)
    d_fn, e_fn = (sdf_fwd, sdf_bwd) if core else saved[:2]
    f_fn, g_fn = (mlp_fwd, mlp_bwd) if trunk else saved[2:]

    def d_rec(*a, **k):
        out = d_fn(*a, **k)
        if feat_error is not None and not (record or {}).get("feat"):
            out = (out[0], out[1] + feat_error, *out[2:])
        if record is not None:
            record.setdefault("d_args", a[:3])
            record.setdefault("feat", []).append(out[1].detach().clone())
        return out

    def f_rec(*a, **k):
        out = f_fn(*a, **k)
        if record is not None:
            record.setdefault("z", []).append(out[1].detach().float().clone())
        return out

    @contextlib.contextmanager
    def swapped():
        cs.sdf_stash_fwd, cs.sdf_stash_bwd, cs.mlp_stash_fwd, cs.mlp_stash_bwd = d_rec, e_fn, f_rec, g_fn
        try:
            yield
        finally:
            cs.sdf_stash_fwd, cs.sdf_stash_bwd, cs.mlp_stash_fwd, cs.mlp_stash_bwd = saved

    return swapped()


def report(label: str, a: tuple, b: tuple, k: int = 4) -> None:
    rows = []
    for name, g in b[0].items():
        err = (a[0][name] - g).abs()
        rows.append((err.max().item() / max(g.abs().max().item(), 1e-30),
                     err.norm().item() / max(g.norm().item(), 1e-30), name))
    rows.sort(reverse=True)
    worst = "; ".join(f"{n} {m:.3e} (norm {r:.3e})" for m, r, n in rows[:k])
    print(f"  {label}: loss {a[1]:.7f} vs {b[1]:.7f}; worst leaves by max / scale: {worst}", flush=True)


def main() -> int:
    sys.path.insert(0, str(REPO))
    import numpy as np
    import torch

    from chip_smoke import HUGE_K, TRAIN_WARMUP, fresh_state, step_grads, train_data, with_model, with_renderer
    from nrhints_torch.kernels import core_stash as cs, cuda_lib
    from nrhints_torch.train.step import make_train_step

    widths = [int(a) for a in sys.argv[1:]] or [256, 512, 1024]
    dev = torch.device("cuda")
    td = train_data(dev, 128, 128)
    # Phase 23(b)'s draws: its batches, then the 64 rays.
    batch = [td["next_batch"]() for _ in range(HUGE_K + TRAIN_WARMUP)][0]
    b64 = td["next_batch"](64)
    for width in widths:
        cfg = with_renderer(with_model(td["cfg"], sdf={"d_hidden": width}), shadow_final_impl="xla")
        state, buffers = fresh_state(cfg, td["n_views"], dev)
        step_fn = make_train_step(cfg, td["camera"], buffers, state.optimizer)
        state, _ = step_fn(state, batch, torch.Generator(device=dev).manual_seed(0))
        urng = np.random.default_rng(7)
        u64 = {"strat": urng.random((64, 1), dtype=np.float32),
               "shadow": urng.random((64, cfg.model.renderer.n_shadow_samples), dtype=np.float32)}
        args = (cfg, state, td["camera"], buffers, b64, u64)
        runs, launched, seen = {}, {}, {}
        for mode, swap in (("kernels", None), ("plain", (True, True)), ("core", (True, False)),
                           ("trunk", (False, True))):
            cuda_lib.reset_launch_counts()
            seen[mode] = {}
            with plain_on_card(*(swap or (False, False)), record=seen[mode]):
                runs[mode] = step_grads(*args, "cuda")
            launched[mode] = {k: v for k, v in cuda_lib.launch_counts.items() if v}
        err = seen["kernels"]["feat"][0] - seen["plain"]["feat"][0]
        perm = torch.randperm(err.shape[0], generator=torch.Generator().manual_seed(0)).to(err.device)
        seen["shuffled"] = {}
        with plain_on_card(record=seen["shuffled"], feat_error=err[perm]):
            runs["shuffled"] = step_grads(*args, "cuda")
        cpu = step_grads(*args, "cpu")
        print(f"d_hidden {width}: launched {launched}", flush=True)
        for a, b in (("kernels", "cpu"), ("plain", "cpu"), ("core", "cpu"), ("trunk", "cpu"), ("kernels", "plain"),
                     ("kernels", "core"), ("kernels", "trunk"), ("shuffled", "plain")):
            report(f"{a} vs {b}", runs[a], cpu if b == "cpu" else runs[b])
        # D's feature on the same points (the step's first call, before any
        # kernel has moved the points), and the trunk's ReLU masks.
        fk, fp = seen["kernels"]["feat"][0], seen["plain"]["feat"][0]
        zk, zp, zs = seen["kernels"]["z"][0], seen["plain"]["z"][0], seen["shuffled"]["z"][0]
        flips, s_flips = int(((zk > 0) != (zp > 0)).sum()), int(((zs > 0) != (zp > 0)).sum())
        weights, x, c = seen["plain"]["d_args"]
        torch.backends.cuda.matmul.allow_tf32 = False
        f32 = cs.sdf_core_fwd_hs_plain(weights, x, c, "float32", "float32")[1]
        for name, f in (("kernel D", fk), ("plain D at bf16", fp)):
            e, sc = f - f32, f32.abs().max().item()
            print(f"  feature: {name} against plain D at f32: max {e.abs().max().item() / sc:.3e}, mean "
                  f"{e.mean().item() / sc:+.3e} of its scale, relative norm {e.norm().item() / f32.norm().item():.3e}",
                  flush=True)
        print(f"  feature: kernel D against plain D on the step's {fk.shape[0]} points: max abs err "
              f"{(fk - fp).abs().max().item():.3e}, {(fk - fp).abs().max().item() / fp.abs().max().item():.3e} of "
              f"its scale; the trunk's z_i: {flips} of {zk.numel()} change sign between the kernels' step and the "
              f"plain step, {s_flips} between the shuffled step and the plain step", flush=True)
        del state, step_fn, buffers
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
