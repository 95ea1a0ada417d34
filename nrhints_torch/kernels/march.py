"""The hierarchical SDF marches: kernels B, C, K, L, M and N and their
plain versions (port of ``nrhints_tpu/kernels/march.py``).

* ``fused_importance_z``: [B, n0] stratified z -> [B, 128] refined, sorted
  z, routed by the JAX keywords: kernel M (``importance_march``, the
  monolith) or, with ``split``, the initial sweep by kernel K
  (``march_sweep``) or plain matmuls (``_mlp_sdf_3d``), then the rounds by
  kernel L (``march_rounds``) or by one launch of kernel B a round
  (``round_machinery``, merge and inverse-CDF draw; the last also merges
  the last round's samples) between plain sweeps of the new samples.
* ``fused_shadow_tau``: the shadow march, kernel N (``shadow_march``) or,
  with ``split``, the same refinement from the light followed by kernel C
  (``shadow_final``, the final sdf + directional-derivative sweep and the
  transmittance) or its plain version -> tau [B, 1].
* ``merge`` picks the sorted merge of every round: "bitonic" or "rank".
* The geometry: n0 = 128 - rounds * n_new stratified samples, then
  ``rounds`` rounds of ``n_new`` samples (the presets: 64 + 4 x 16).

On CUDA tensors the wrappers launch the kernels in ``csrc/march.cu``,
``csrc/march_fused.cu`` (the wide class: ``march_fused_wide.cu``; the huge
class: ``march_fused_huge.cu``) and ``csrc/march_geom.cu`` /
``march_geom_f32.cu``; on CPU tensors they run the ``*_plain`` versions.
The march weights hold the matrices in the march
dtype (bf16 by default) and the biases in f32; a bf16 sweep rounds its
activations to bf16 after every layer, as the JAX sweeps do.  The weights'
dtype picks the instance of C, K, L, M and N: bf16 weights the bf16
kernels, f32 weights (``march_dtype="float32"``) their f32 instances
(``*_f32``: f32 weights, activations and FMAs, no rounding), counted under
their own names.  The SDF's widths pick the row engine's class
(``core_mlp.core_class(cfg, with_feat=False)``): the presets' widths
(padded widths up to 256, encodings up to 64) the instances above, wider
SDFs up to 512 and 128 the wide instances (``*_wide``, ``*_f32_wide``),
and any wider SDF the huge instances (``*_huge``, bf16 weights only: 64
rows a pass in a device-memory scratch of ``core_mlp.march_layout``'s size,
allocated per call on the caller's stream, so a CUDA graph's capture keeps
it in its pool); there f32 weights raise ``NotImplementedError`` naming
ROADMAP.md Queue 2 item 15 before any launch.  The
geometry picks the instance too: 64 + 4 x 16 (K: n0 = 64; B: n_new = 16)
the compile-time instances, every other geometry of ``GEOMETRY_RANGE`` the
run-time ones (``*_geom``, counted under their own names); outside it the
card raises ``NotImplementedError`` before any launch (``check_geometry``).
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F

from nrhints_torch.fields.sdf import SDFNetConfig
from nrhints_torch.kernels import cuda_lib
from nrhints_torch.kernels.common import INV_SQRT2, materialize_sdf_weights, softplus100_gate
from nrhints_torch.kernels.core_mlp import (
    ROWS_HUGE, check_scratch, march_layout, meta_args, pack_sdf_mlp, require_cuda,
)

BIG_Z = 1e9  # padding depth; exceeds any real depth
N_BUF = 128  # slots of the z / sdf buffers (n0 stratified + rounds x n_new importance)
FIXED_GEOMETRY = (4, 16)  # (rounds, n_new) of the compile-time instances: 64 + 4 x 16
GEOMETRY_RANGE = (
    "rounds >= 1, n_new >= 2 and n0 = 128 - rounds * n_new >= 2, with a power-of-two n_new under merge='rank'"
)


def check_geometry(rounds: int, n_new: int, merge: str = "bitonic") -> int:
    """n0 of a march geometry that kernels B, K, L, M and N take on the card
    (``GEOMETRY_RANGE``); raises ``NotImplementedError`` naming the range
    otherwise.  JAX returns NaN at n_new = 1 (u = 1 - k / 0) and at n0 = 1
    (no valid interval), and drops the stratified samples at rounds = 0.
    The card's wrappers call it before any launch; the plain versions take
    what they are given."""
    n0 = N_BUF - rounds * n_new
    if rounds < 1 or n_new < 2 or n0 < 2 or (merge == "rank" and n_new & (n_new - 1)):
        raise NotImplementedError(
            f"the march kernels on the card take {GEOMETRY_RANGE}; got {rounds} rounds of {n_new} samples "
            f"(n0 = {n0}) under merge={merge!r}"
        )
    return n0


# ---------------------------------------------------------------------------
# The MLP sweeps on [B, S, 3] points (plain matmuls on either device)


def _pe_3d(pts: torch.Tensor, num_freqs: int) -> torch.Tensor:
    scaled = torch.cat([pts[..., d : d + 1] * (2.0**f) for d in range(3) for f in range(num_freqs)], -1)
    return torch.cat([pts, torch.sin(scaled), torch.sin(scaled + math.pi / 2.0)], dim=-1)


def _pe_3d_with_tangent(pts: torch.Tensor, tans: torch.Tensor, num_freqs: int):
    scaled = torch.cat([pts[..., d : d + 1] * (2.0**f) for d in range(3) for f in range(num_freqs)], -1)
    tscaled = torch.cat([tans[..., d : d + 1] * (2.0**f) for d in range(3) for f in range(num_freqs)], -1)
    sin_b = torch.sin(scaled)
    cos_b = torch.sin(scaled + math.pi / 2.0)
    enc = torch.cat([pts, sin_b, cos_b], dim=-1)
    tenc = torch.cat([tans, tscaled * cos_b, -tscaled * sin_b], dim=-1)
    return enc, tenc


def _rounder(weights):
    """Rounds an f32 tensor to the weights' dtype and back (a no-op for f32
    weights): the march sweeps carry bf16 activations between layers."""
    if weights[0].dtype == torch.float32:
        return lambda t: t
    dt = weights[0].dtype
    return lambda t: t.to(dt).float()


def _mlp_sdf_3d(pts: torch.Tensor, weights: Sequence[torch.Tensor], cfg: SDFNetConfig) -> torch.Tensor:
    """[B, S, 3] raw points -> [B, S] sdf; products with f32 accumulation."""
    r = _rounder(weights)
    b, s = pts.shape[0], pts.shape[1]
    enc = _pe_3d(pts * cfg.scale, cfg.multi_res).reshape(b * s, -1)
    h = r(enc)
    for i in range(cfg.n_layers):
        if i in cfg.skip_in:
            h = r(torch.cat([h, enc], dim=-1) * INV_SQRT2)
        h = r(F.softplus(100.0 * (h @ weights[2 * i].float() + weights[2 * i + 1])) * 0.01)
    sdf = (h @ weights[-2].float() + weights[-1]) / cfg.scale
    return sdf[:, 0].reshape(b, s)


def _mlp_sdf_dirderiv_3d(pts, dirs, weights, cfg: SDFNetConfig):
    """-> (sdf [B, S], dirs . grad sdf [B, S]) by one forward-mode tangent;
    the tangent is multiplied by the f32 gate before its rounding."""
    r = _rounder(weights)
    b, s = pts.shape[0], pts.shape[1]
    enc, tenc = _pe_3d_with_tangent(pts * cfg.scale, dirs * cfg.scale, cfg.multi_res)
    enc, tenc = enc.reshape(b * s, -1), tenc.reshape(b * s, -1)
    h, th = r(enc), r(tenc)
    for i in range(cfg.n_layers):
        if i in cfg.skip_in:
            h = r(torch.cat([h, enc], dim=-1) * INV_SQRT2)
            th = r(torch.cat([th, tenc], dim=-1) * INV_SQRT2)
        w = weights[2 * i].float()
        sp, gate = softplus100_gate(h @ w + weights[2 * i + 1])
        th = r((th @ w) * gate)
        h = r(sp)
    w = weights[-2].float()
    sdf = (h @ w + weights[-1]) / cfg.scale
    dsdf = (th @ w) / cfg.scale
    return sdf[:, 0].reshape(b, s), dsdf[:, 0].reshape(b, s)


def march_weights(params: dict, cfg: SDFNetConfig, mlp_dtype: str) -> list:
    """(w0, b0, ..., w_sdf, b_sdf): matrices in ``mlp_dtype``, biases f32."""
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[mlp_dtype]
    return [a.to(dt) if a.dim() == 2 else a.float() for a in materialize_sdf_weights(params, cfg)]


# ---------------------------------------------------------------------------
# Kernel B: merge + inverse-CDF draw


# The draw compares the total cdf with u = 1 exactly, so the last ulp of the
# prefix sums decides where the u = 1 sample lands (at the last valid z, or
# somewhere in the last interval).  Every summation order is as right as
# another; the plain version sums in kernel B's order (32-lane Kogge-Stone
# scans, then the warp totals in order) so the two agree at that tie.


def _excl_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix sum over the last axis (128 = 4 warps x 32 lanes)."""
    b, n = x.shape
    inc = x.reshape(b, n // 32, 32)
    o = 1
    while o < 32:
        inc = inc + F.pad(inc[..., :-o], (o, 0))
        o *= 2
    exc = F.pad(inc[..., :-1], (1, 0))
    base, bases = torch.zeros_like(inc[:, 0, 31]), []
    for w in range(n // 32):
        bases.append(base)
        base = base + inc[:, w, 31]
    return (exc + torch.stack(bases, dim=1)[..., None]).reshape(b, n)


def _sum128(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in kernel B's order (xor butterflies in each
    warp, then (w0 + w1) + (w2 + w3)) -> [B, 1]."""
    b, n = x.shape
    v = x.reshape(b, n // 32, 32)
    lane = torch.arange(32, device=x.device)
    for o in (16, 8, 4, 2, 1):
        v = v + v[..., lane ^ o]
    t = v[..., 0]
    return ((t[:, 0] + t[:, 1]) + (t[:, 2] + t[:, 3]))[:, None]


def _bitonic_merge(z: torch.Tensor, payload: torch.Tensor):
    """Sort a bitonic [B, 128] row ascending, moving the payload with z:
    the 7-stage network of the JAX ``_bitonic_merge`` (partner lane k ^ d;
    the upper lane of a pair keeps the larger value; ties stay put)."""
    n = z.shape[-1]
    idx = torch.arange(n, device=z.device)
    d = n // 2
    while d >= 1:
        partner = idx ^ d
        hi = (idx & d) != 0
        p, pp = z[:, partner], payload[:, partner]
        take = torch.where(hi, p > z, p < z)
        payload = torch.where(take, pp, payload)
        z = torch.where(take, p, z)
        d //= 2
    return z, payload


def rank_merge_plain(z: torch.Tensor, payload: torch.Tensor, n_new: int):
    """Port of ``_rank_merge``: merge [B, 128] = [old (128 - n_new,
    ascending, BIG_Z pad included) | new (n_new, descending)] by sending
    each element straight to its rank in a stable old-before-new merge: old
    i to i + #{new < old_i}, new j to n_new - 1 - j + #{old <= new_j} (the
    places JAX's shift network and one-hot scatter put them).  The z row
    equals the bitonic merge's; the payload differs only among tied z."""
    k = z.shape[-1] - n_new
    old_z, new_z = z[:, :k], z[:, k:]
    s_old = torch.sum(new_z[:, None, :] < old_z[:, :, None], dim=-1)
    cnt_new = torch.sum(old_z[:, None, :] <= new_z[:, :, None], dim=-1)
    dest = torch.cat([
        torch.arange(k, device=z.device) + s_old,
        (n_new - 1) - torch.arange(n_new, device=z.device) + cnt_new,
    ], dim=-1)
    return torch.empty_like(z).scatter_(1, dest, z), torch.empty_like(payload).scatter_(1, dest, payload)


def _merge_math(z, sdf, new_z, new_sdf, valid_n: int, n_new: int, merge: str = "bitonic"):
    lane = torch.arange(N_BUF - n_new, device=z.device)
    z_cat = torch.cat([torch.where(lane < valid_n, z[:, : N_BUF - n_new], BIG_Z), new_z], dim=-1)
    sdf_cat = torch.cat([sdf[:, : N_BUF - n_new], new_sdf], dim=-1)
    if merge == "rank":
        return rank_merge_plain(z_cat, sdf_cat, n_new)
    return _bitonic_merge(z_cat, sdf_cat)


def _round_new_z(z, sdf, valid_n: int, inv_s: float, oo, od, n_new: int) -> torch.Tensor:
    """One up-sample round on [B, 128] buffers -> new_z [B, n_new] in
    descending order (NeuS up_sample + the deterministic sample_pdf)."""
    lane = torch.arange(N_BUF, device=z.device)
    interval_valid = lane < valid_n - 1
    nxt_z = torch.roll(z, -1, dims=1)
    nxt_s = torch.roll(sdf, -1, dims=1)
    r2 = oo + 2.0 * od * z + z * z
    r2n = oo + 2.0 * od * nxt_z + nxt_z * nxt_z
    inside = ((r2 < 1.0) | (r2n < 1.0)).to(z.dtype)

    mid_sdf = (sdf + nxt_s) * 0.5
    cos_val = (nxt_s - sdf) / (nxt_z - z + 1e-5)
    prev_cos = torch.where(lane == 0, 0.0, torch.roll(cos_val, 1, dims=1))
    cos_val = torch.clamp(torch.minimum(prev_cos, cos_val), -1e3, 0.0) * inside

    dist = nxt_z - z
    prev_cdf = torch.sigmoid((mid_sdf - cos_val * dist * 0.5) * inv_s)
    next_cdf = torch.sigmoid((mid_sdf + cos_val * dist * 0.5) * inv_s)
    alpha = torch.minimum((prev_cdf - next_cdf + 1e-5) / (prev_cdf + 1e-5), torch.ones_like(z))
    alpha = torch.where(interval_valid, alpha, 0.0)
    w = alpha * torch.exp(_excl_cumsum(torch.log(1.0 - alpha + 1e-7)))

    pdf = torch.where(interval_valid, w + 1e-5, 0.0)
    pdf = pdf / _sum128(pdf)
    cdf = _excl_cumsum(pdf)
    cdf_cnt = torch.where(lane < valid_n, cdf, 2.0)
    u = 1.0 - torch.arange(n_new, dtype=z.dtype, device=z.device) / (n_new - 1)
    inds = torch.sum(cdf_cnt[:, None, :] <= u[None, :, None], dim=-1)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=valid_n - 1)
    cdf_b, z_b = torch.gather(cdf, 1, below), torch.gather(z, 1, below)
    cdf_a, z_a = torch.gather(cdf, 1, above), torch.gather(z, 1, above)
    denom = cdf_a - cdf_b
    denom = torch.where(denom < 1e-5, 1.0, denom)
    t = (u - cdf_b) / denom
    return z_b + t * (z_a - z_b)


def round_machinery_plain(
    z, sdf, o, d, new_z_prev, new_sdf_prev, merge_valid_n, next_valid_n, inv_s, n_new=16, merge="bitonic",
    last=False,
):
    """Port of one ``_round_machinery_kernel`` step -> (new_z [B, n_new] or
    None, z [B, 128], sdf [B, 128] or None).  ``merge_valid_n`` not None:
    merge (new_z_prev, new_sdf_prev) in first (by ``merge``, "bitonic" or
    "rank"); ``next_valid_n`` not None: draw the next round's samples at
    ``inv_s`` (the tail step does not, and drops the dead sdf buffer).
    ``last`` (with a draw): then merge the drawn samples in with a zero sdf
    and return (None, z, None), as JAX's last round step followed by its
    tail step (``_rounds_xla``: the last round's samples are never swept)."""
    if merge_valid_n is not None:
        z, sdf = _merge_math(z, sdf, new_z_prev, new_sdf_prev, merge_valid_n, n_new, merge)
    if next_valid_n is None:
        if last:
            raise ValueError("last=True merges the samples it draws: it needs next_valid_n")
        return None, z, None
    oo = torch.sum(o * o, dim=-1, keepdim=True)
    od = torch.sum(o * d, dim=-1, keepdim=True)
    new_z = _round_new_z(z, sdf, next_valid_n, inv_s, oo, od, n_new)
    if last:
        return None, _merge_math(z, sdf, new_z, torch.zeros_like(new_z), next_valid_n, n_new, merge)[0], None
    return new_z, z, sdf


def round_machinery(
    z, sdf, o, d, new_z_prev, new_sdf_prev, merge_valid_n, next_valid_n, inv_s, n_new=16, merge="bitonic",
    last=False,
):
    """One merge/draw step: kernel B on CUDA tensors, the plain version on
    CPU tensors (same signature and results as ``round_machinery_plain``).
    On the card n_new = 16 runs ``round_machinery``, any other n_new that a
    geometry of ``GEOMETRY_RANGE`` has (2 to 126) ``round_machinery_geom``."""
    if z.device.type == "cpu":
        return round_machinery_plain(
            z, sdf, o, d, new_z_prev, new_sdf_prev, merge_valid_n, next_valid_n, inv_s, n_new, merge, last
        )
    check_geometry(1, n_new, merge)
    if last and next_valid_n is None:
        raise ValueError("last=True merges the samples it draws: it needs next_valid_n")
    b = z.shape[0]
    for t, shape, name in ((z, (b, N_BUF), "z"), (sdf, (b, N_BUF), "sdf"), (o, (b, 3), "o"), (d, (b, 3), "d")):
        require_cuda(t, shape, name)
    if merge_valid_n is not None:
        require_cuda(new_z_prev, (b, n_new), "new_z_prev")
        require_cuda(new_sdf_prev, (b, n_new), "new_sdf_prev")
    dev = z.device
    draws = next_valid_n is not None and not last  # the step returns its draws and sdf buffer
    new_z = torch.empty((b, n_new), device=dev) if draws else None
    z_out = torch.empty((b, N_BUF), device=dev)
    sdf_out = torch.empty((b, N_BUF), device=dev) if draws else None
    if b == 0:
        return new_z, z_out, sdf_out
    lib = cuda_lib.load("march")
    fixed = n_new == FIXED_GEOMETRY[1]
    fn = "round_machinery" if fixed else "round_machinery_geom"
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    rc = getattr(lib, fn)(
        z.data_ptr(), sdf.data_ptr(), o.data_ptr(), d.data_ptr(),
        ptr(new_z_prev if merge_valid_n is not None else None),
        ptr(new_sdf_prev if merge_valid_n is not None else None),
        ptr(new_z), z_out.data_ptr(), ptr(sdf_out), b,
        -1 if merge_valid_n is None else merge_valid_n,
        -1 if next_valid_n is None else next_valid_n,
        0.0 if inv_s is None else float(inv_s), int(merge == "rank"), int(last), *(() if fixed else (n_new,)),
        cuda_lib.stream_ptr(dev),
    )
    cuda_lib.check(lib, rc, fn)
    cuda_lib.launch_counts[fn] += 1
    return new_z, z_out, sdf_out


def _rounds(weights, cfg, rays_o, rays_d, z0, sdf0, rounds, n_new, base_inv_s, merge, machinery, sweep=None):
    """[B, n0] (z0, sdf0) -> [B, 128] refined z: one ``machinery`` step per
    round (merging the previous round's samples, drawing the next) and a
    ``sweep`` of the n_new new samples between steps (default the plain
    one).  The last round's samples are not swept (their sdf is a payload
    nobody reads): its step merges them in with a zero sdf itself
    (``last``), where JAX launches a merge-only tail step."""
    sweep = sweep or march_sweep_plain
    b, n0 = z0.shape
    pad = torch.full((b, N_BUF - n0), BIG_Z, device=z0.device)
    z = torch.cat([z0, pad], dim=-1)
    sdf = torch.cat([sdf0, torch.zeros_like(pad)], dim=-1)
    n_start = N_BUF - rounds * n_new
    new_z = new_sdf = None
    for i in range(rounds):
        valid_n = n_start + i * n_new
        last = i + 1 == rounds
        new_z, z, sdf = machinery(
            z, sdf, rays_o, rays_d, new_z, new_sdf,
            None if i == 0 else valid_n - n_new, valid_n, base_inv_s * float(2**i), n_new, merge, last,
        )
        if not last:
            new_sdf = sweep(new_z, rays_o, rays_d, weights, cfg)
    return z


# ---------------------------------------------------------------------------
# Kernel C: final sweep + transmittance


def shadow_final_plain(z, o, d, sdist, inv_s, cos_anneal, weights, cfg: SDFNetConfig) -> torch.Tensor:
    """Port of ``_shadow_final_math``: refined z [B, 128] -> tau [B, 1]."""
    lane = torch.arange(N_BUF, device=z.device)
    dists = torch.where(lane == N_BUF - 1, sdist, torch.roll(z, -1, dims=1) - z)
    mid = z + dists * 0.5
    pts = o[:, None, :] + d[:, None, :] * mid[..., None]
    sdf_f, dcos = _mlp_sdf_dirderiv_3d(pts, d[:, None, :].expand_as(pts), weights, cfg)
    iter_cos = -(torch.relu(-dcos * 0.5 + 0.5) * (1.0 - cos_anneal) + torch.relu(-dcos) * cos_anneal)
    pcdf = torch.sigmoid((sdf_f - iter_cos * dists * 0.5) * inv_s)
    ncdf = torch.sigmoid((sdf_f + iter_cos * dists * 0.5) * inv_s)
    alpha = torch.clamp((pcdf - ncdf + 1e-5) / (pcdf + 1e-5), 0.0, 1.0)
    logs = torch.where(lane < N_BUF - 1, torch.log(1.0 - alpha + 1e-7), 0.0)
    return torch.exp(torch.sum(logs, dim=-1, keepdim=True))


def _kernel_fn(fn: str, weights) -> tuple[str, torch.dtype]:
    """(entry point, packed weight dtype) of a march kernel's instance for
    the weights' dtype: bf16 -> ``fn``, f32 -> ``fn``_f32."""
    dt = weights[0].dtype
    if dt == torch.bfloat16:
        return fn, dt
    if dt == torch.float32:
        return f"{fn}_f32", dt
    raise ValueError(f"{fn}: the march kernels take bf16 or f32 march weights, got {dt}")


def _kernel_pack(fn: str, weights, cfg: SDFNetConfig) -> tuple[str, dict]:
    """(entry point, pack) of a march kernel's instance: ``_kernel_fn``'s,
    then ``_wide`` or ``_huge`` for the row engine's wide or huge class (the
    pack's "cls", ``core_mlp.core_class``, which raises
    ``NotImplementedError`` naming item 15 for f32 weights above the wide
    class, before any launch)."""
    fn, dt = _kernel_fn(fn, weights)
    pk = pack_sdf_mlp(weights, cfg, with_feat=False, dtype=dt)
    return fn + pk["cls"].suffix, pk


def _rows_args(fn: str, pk: dict, b: int, dev) -> tuple:
    """The trailing arguments of entry point ``fn`` at b rays: the huge
    class's rows scratch (``march_layout``; checked against the card's
    memory, ``check_scratch``; allocated on the current stream and kept
    alive by the caller until the launch is queued), else none."""
    if pk["cls"] is not ROWS_HUGE:
        return ()
    n = march_layout(b, pk)[1]
    check_scratch(4 * n, dev, fn)
    return (torch.empty(n, dtype=torch.float32, device=dev),)


def shadow_final(z, o, d, sdist, inv_s, cos_anneal, weights, cfg: SDFNetConfig) -> torch.Tensor:
    """tau [B, 1]: kernel C on CUDA tensors (its bf16 or f32 instance, by
    the weights' dtype, of the SDF's width class), the plain version on CPU
    tensors.  ``inv_s`` and ``cos_anneal`` may be 0-d tensors; the kernel
    reads them on the device, so no host sync."""
    if z.device.type == "cpu":
        return shadow_final_plain(z, o, d, sdist, inv_s, cos_anneal, weights, cfg)
    b, dev = z.shape[0], z.device
    for t, shape, name in ((z, (b, N_BUF), "z"), (o, (b, 3), "o"), (d, (b, 3), "d"), (sdist, (b, 1), "sdist")):
        require_cuda(t, shape, name)
    if b == 0:
        return torch.empty((b, 1), device=dev)
    fn, pk = _kernel_pack("shadow_final", weights, cfg)
    return _launch_final(fn, pk, cfg, z, o, d, sdist, inv_s, cos_anneal)


def _launch_final(fn: str, pk: dict, cfg: SDFNetConfig, z, o, d, sdist, inv_s, cos_anneal) -> torch.Tensor:
    """``shadow_final``'s launch of entry point ``fn`` (its class's suffix
    included) with the pack ``pk`` on checked CUDA tensors: the huge
    class's rows scratch (``_rows_args``), then the launch, counted under
    ``fn``."""
    b, dev = z.shape[0], z.device
    tau = torch.empty((b, 1), device=dev)
    inv_s_t = torch.as_tensor(inv_s, dtype=torch.float32, device=dev).reshape(1)
    anneal_t = torch.as_tensor(cos_anneal, dtype=torch.float32, device=dev).reshape(1)
    rows = _rows_args(fn, pk, b, dev)
    lib = cuda_lib.load("march")
    rc = getattr(lib, fn)(
        z.data_ptr(), o.data_ptr(), d.data_ptr(), sdist.data_ptr(),
        pk["wpack"].data_ptr(), pk["bpack"].data_ptr(), pk["w_sdf"].data_ptr(),
        inv_s_t.data_ptr(), anneal_t.data_ptr(), tau.data_ptr(), b, *meta_args(pk),
        float(cfg.scale), cuda_lib.stream_ptr(dev), *(t.data_ptr() for t in rows),
    )
    cuda_lib.check(lib, rc, fn)
    cuda_lib.launch_counts[fn] += 1
    return tau


# ---------------------------------------------------------------------------
# Kernels K, L, M and N: the fused marches (csrc/march_fused.cu at 64 + 4 x
# 16, csrc/march_geom.cu at every other geometry)


def march_sweep_plain(z0, o, d, weights, cfg: SDFNetConfig) -> torch.Tensor:
    """Port of ``_sweep_kernel``: the initial sweep, sdf0 [B, n0] at
    o + d z0."""
    return _mlp_sdf_3d(o[:, None, :] + d[:, None, :] * z0[..., None], weights, cfg)


def march_rounds_plain(
    z0, sdf0, o, d, weights, cfg: SDFNetConfig, *, rounds=4, n_new=16, base_inv_s=64.0, merge="bitonic"
) -> torch.Tensor:
    """Port of ``_rounds_kernel`` (the ``_refine_rounds`` loop): -> refined
    z [B, 128], with plain machinery steps and plain sweeps."""
    return _rounds(weights, cfg, o, d, z0, sdf0, rounds, n_new, base_inv_s, merge, round_machinery_plain)


def importance_march_plain(
    z0, o, d, weights, cfg: SDFNetConfig, *, rounds=4, n_new=16, base_inv_s=64.0, merge="bitonic"
) -> torch.Tensor:
    """Port of ``_importance_kernel``: the sweep, then the rounds."""
    sdf0 = march_sweep_plain(z0, o, d, weights, cfg)
    return march_rounds_plain(
        z0, sdf0, o, d, weights, cfg, rounds=rounds, n_new=n_new, base_inv_s=base_inv_s, merge=merge
    )


def shadow_march_plain(
    z0, o, d, sdist, inv_s, cos_anneal, weights, cfg: SDFNetConfig, *,
    rounds=4, n_new=16, base_inv_s=64.0, merge="bitonic",
) -> torch.Tensor:
    """Port of ``_shadow_kernel``: the importance march, then the final
    sweep -> tau [B, 1]."""
    z = importance_march_plain(z0, o, d, weights, cfg, rounds=rounds, n_new=n_new, base_inv_s=base_inv_s, merge=merge)
    return shadow_final_plain(z, o, d, sdist, inv_s, cos_anneal, weights, cfg)


def _check_merge(merge: str) -> int:
    if merge not in ("bitonic", "rank"):
        raise ValueError(f"merge must be 'bitonic' or 'rank', got {merge!r}")
    return int(merge == "rank")


def _launch_fused(fn: str, weights, cfg: SDFNetConfig, inputs, out_cols: int, scalars=(),
                  geometry=None) -> torch.Tensor:
    """Kernel ``fn`` of ``csrc/march_fused.cu`` (or its f32 instance, or
    its wide one in ``march_fused_wide.cu``, or its huge one in
    ``march_fused_huge.cu``: ``_kernel_pack``) on CUDA tensors: checks ``inputs``
    ([(tensor, shape, name), ...], the kernel's pointer arguments in
    order), packs the weights in their dtype, launches -> [B, out_cols].
    ``geometry``: None for the 64 + 4 x 16 instance, else the ints that the
    run-time geometry instance (``fn``_geom, ``csrc/march_geom.cu``, f32:
    ``march_geom_f32.cu``, huge: ``march_fused_huge.cu``) takes after the
    scalars."""
    for t, shape, tname in inputs:
        require_cuda(t, shape, tname)
    if inputs[0][0].shape[0] == 0:
        return torch.empty((0, out_cols), device=inputs[0][0].device)
    fn, pk = _kernel_pack(fn, weights, cfg)
    return _launch_pack(fn, pk, cfg, inputs, out_cols, scalars, geometry)


def _launch_pack(fn: str, pk: dict, cfg: SDFNetConfig, inputs, out_cols: int, scalars=(),
                 geometry=None) -> torch.Tensor:
    """``_launch_fused``'s launch of entry point ``fn`` (its class's suffix
    included) with the pack ``pk``: the huge class's rows scratch
    (``_rows_args``), then the launch, counted under ``fn`` (+ "_geom")."""
    dev, b = inputs[0][0].device, inputs[0][0].shape[0]
    out = torch.empty((b, out_cols), device=dev)
    if geometry is not None:
        fn += "_geom"
    rows = _rows_args(fn, pk, b, dev)
    if pk["cls"] is ROWS_HUGE:
        lib = cuda_lib.load("march_fused_huge")
    elif geometry is None:
        lib = cuda_lib.load("march_fused_wide" if fn.endswith("_wide") else "march_fused")
    else:
        lib = cuda_lib.load("march_geom_f32" if "_f32" in fn else "march_geom")
    rc = getattr(lib, fn)(
        *(t.data_ptr() for t, _, _ in inputs), pk["wpack"].data_ptr(), pk["bpack"].data_ptr(),
        pk["w_sdf"].data_ptr(), out.data_ptr(), b, *meta_args(pk), float(cfg.scale), *scalars,
        *(geometry or ()), cuda_lib.stream_ptr(dev), *(t.data_ptr() for t in rows),
    )
    cuda_lib.check(lib, rc, fn)
    cuda_lib.launch_counts[fn] += 1
    return out


def _ray_inputs(z0, o, d, n0: int):
    b = z0.shape[0]
    return [(z0, (b, n0), "z0"), (o, (b, 3), "o"), (d, (b, 3), "d")]


def _rounds_geometry(rounds: int, n_new: int, merge: str) -> tuple:
    """(n0, ``_launch_fused``'s geometry) of L, M or N, checked first."""
    n0 = check_geometry(rounds, n_new, merge)
    return n0, None if (rounds, n_new) == FIXED_GEOMETRY else (rounds, n_new)


def march_sweep(z0, o, d, weights, cfg: SDFNetConfig) -> torch.Tensor:
    """sdf0 [B, n0]: kernel K on CUDA tensors (its bf16 or f32 instance,
    by the weights' dtype), the plain version on CPU tensors.  The card
    takes the n0 of ``GEOMETRY_RANGE``, 2 to 126."""
    if z0.device.type == "cpu":
        return march_sweep_plain(z0, o, d, weights, cfg)
    n0 = z0.shape[1]
    if not 2 <= n0 <= N_BUF - 2:
        raise NotImplementedError(f"kernel K sweeps the n0 of {GEOMETRY_RANGE}, 2 to {N_BUF - 2}; got n0 = {n0}")
    n0_fixed = N_BUF - FIXED_GEOMETRY[0] * FIXED_GEOMETRY[1]
    return _launch_fused("march_sweep", weights, cfg, _ray_inputs(z0, o, d, n0), n0,
                         geometry=None if n0 == n0_fixed else (n0,))


def march_rounds(
    z0, sdf0, o, d, weights, cfg: SDFNetConfig, *, rounds=4, n_new=16, base_inv_s=64.0, merge="bitonic"
) -> torch.Tensor:
    """Refined z [B, 128] from (z0, sdf0): kernel L on CUDA tensors, the
    plain version on CPU tensors."""
    rank = _check_merge(merge)
    if z0.device.type == "cpu":
        return march_rounds_plain(
            z0, sdf0, o, d, weights, cfg, rounds=rounds, n_new=n_new, base_inv_s=base_inv_s, merge=merge
        )
    n0, geometry = _rounds_geometry(rounds, n_new, merge)
    inputs = _ray_inputs(z0, o, d, n0)
    inputs.insert(1, (sdf0, (z0.shape[0], n0), "sdf0"))
    return _launch_fused("march_rounds", weights, cfg, inputs, N_BUF, (float(base_inv_s), rank), geometry)


def importance_march(
    z0, o, d, weights, cfg: SDFNetConfig, *, rounds=4, n_new=16, base_inv_s=64.0, merge="bitonic"
) -> torch.Tensor:
    """Refined z [B, 128] from z0: kernel M on CUDA tensors, the plain
    version on CPU tensors."""
    rank = _check_merge(merge)
    if z0.device.type == "cpu":
        return importance_march_plain(
            z0, o, d, weights, cfg, rounds=rounds, n_new=n_new, base_inv_s=base_inv_s, merge=merge
        )
    n0, geometry = _rounds_geometry(rounds, n_new, merge)
    return _launch_fused("importance_march", weights, cfg, _ray_inputs(z0, o, d, n0), N_BUF, (float(base_inv_s), rank),
                         geometry)


def shadow_march(
    z0, o, d, sdist, inv_s, cos_anneal, weights, cfg: SDFNetConfig, *,
    rounds=4, n_new=16, base_inv_s=64.0, merge="bitonic",
) -> torch.Tensor:
    """tau [B, 1] from z0: kernel N on CUDA tensors, the plain version on
    CPU tensors.  ``inv_s`` and ``cos_anneal`` may be 0-d tensors; the
    kernel reads them on the device, so no host sync."""
    rank = _check_merge(merge)
    if z0.device.type == "cpu":
        return shadow_march_plain(
            z0, o, d, sdist, inv_s, cos_anneal, weights, cfg,
            rounds=rounds, n_new=n_new, base_inv_s=base_inv_s, merge=merge,
        )
    n0, geometry = _rounds_geometry(rounds, n_new, merge)
    inputs = _ray_inputs(z0, o, d, n0) + [(sdist, (z0.shape[0], 1), "sdist")] + [
        (torch.as_tensor(v, dtype=torch.float32, device=z0.device).reshape(1), (1,), name)
        for v, name in ((inv_s, "inv_s"), (cos_anneal, "cos_anneal"))
    ]
    return _launch_fused("shadow_march", weights, cfg, inputs, 1, (float(base_inv_s), rank), geometry)


# ---------------------------------------------------------------------------
# Dispatch (JAX fused_importance_z / fused_shadow_tau, march.py:664 / :797)


def _check_args(z0, rounds, n_new, merge, split, impls):
    """JAX's argument checks; on CUDA tensors also ``check_geometry``."""
    if z0.shape[1] != N_BUF - rounds * n_new:
        raise ValueError(
            f"the fused march needs z0 with {N_BUF - rounds * n_new} samples "
            f"(= {N_BUF} buffer - {rounds}x{n_new} refinement), got {z0.shape[1]}"
        )
    _check_merge(merge)
    if merge == "rank" and (n_new & (n_new - 1)) != 0:
        raise ValueError(f"merge='rank' needs a power-of-two n_new (as JAX's shift network), got {n_new}")
    for name, v in impls.items():
        if v not in ("pallas", "xla"):
            raise ValueError(f"{name} must be 'pallas' or 'xla', got {v!r}")
    if not split and "xla" in impls.values():
        raise ValueError(f"{'/'.join(impls)}='xla' require split=True")
    if z0.device.type != "cpu":
        check_geometry(rounds, n_new, merge)


def fused_importance_z(
    params: dict, cfg: SDFNetConfig, rays_o, rays_d, z0, *,
    rounds: int = 4, n_new: int = 16, base_inv_s: float = 64.0,
    mlp_dtype: str = "float32", merge: str = "bitonic", split: bool = False,
    sweep_impl: str = "pallas", rounds_impl: str = "pallas",
) -> torch.Tensor:
    """[B, n0] stratified z -> [B, 128] refined, sorted z (no gradient),
    n0 = 128 - rounds * n_new.

    Routes as JAX: ``split=False`` is kernel M; with ``split`` the sweep is
    kernel K ("pallas") or plain matmuls ("xla"), and the rounds kernel L
    ("pallas") or one launch of kernel B a round between plain sweeps of its
    new samples ("xla").  ``merge``: "bitonic" or "rank".  On the card the
    geometry must lie in ``GEOMETRY_RANGE`` (checked before any launch)."""
    _check_args(z0, rounds, n_new, merge, split, {"sweep_impl": sweep_impl, "rounds_impl": rounds_impl})
    rays_o, rays_d, z0 = rays_o.contiguous(), rays_d.contiguous(), z0.contiguous()
    weights = march_weights(params, cfg, mlp_dtype)
    kw = dict(rounds=rounds, n_new=n_new, base_inv_s=base_inv_s, merge=merge)
    if not split:
        return importance_march(z0, rays_o, rays_d, weights, cfg, **kw)
    if sweep_impl == "xla":
        sweep = march_sweep_plain(z0, rays_o, rays_d, weights, cfg)
    else:
        sweep = march_sweep(z0, rays_o, rays_d, weights, cfg)
    if rounds_impl == "xla":
        return _rounds(weights, cfg, rays_o, rays_d, z0, sweep, rounds, n_new, base_inv_s, merge, round_machinery)
    return march_rounds(z0, sweep, rays_o, rays_d, weights, cfg, **kw)


def fused_shadow_tau(
    params: dict, cfg: SDFNetConfig, ray_o, ray_d, z0, sample_dist, inv_s, cos_anneal_ratio, *,
    rounds: int = 4, n_new: int = 16, base_inv_s: float = 64.0,
    mlp_dtype: str = "float32", split: bool = False, merge: str = "bitonic",
    sweep_impl: str = "pallas", final_impl: str = "pallas", rounds_impl: str = "pallas",
) -> torch.Tensor:
    """Shadow rays -> final transmittance tau [B, 1] (no gradient).

    Routes as JAX: ``split=False`` is kernel N; with ``split`` the
    refinement is ``fused_importance_z`` (split only where an impl is
    "xla", JAX march.py:859, so under the "pallas" impls it is kernel M),
    then the final sweep: kernel C ("pallas") or ``shadow_final_plain`` on
    the full batch ("xla")."""
    _check_args(z0, rounds, n_new, merge, split,
                {"sweep_impl": sweep_impl, "final_impl": final_impl, "rounds_impl": rounds_impl})
    ray_o, ray_d, z0, sample_dist = ray_o.contiguous(), ray_d.contiguous(), z0.contiguous(), sample_dist.contiguous()
    weights = march_weights(params, cfg, mlp_dtype)
    if not split:
        return shadow_march(
            z0, ray_o, ray_d, sample_dist, inv_s, cos_anneal_ratio, weights, cfg,
            rounds=rounds, n_new=n_new, base_inv_s=base_inv_s, merge=merge,
        )
    z = fused_importance_z(
        params, cfg, ray_o, ray_d, z0, rounds=rounds, n_new=n_new, base_inv_s=base_inv_s, mlp_dtype=mlp_dtype,
        merge=merge, split=sweep_impl == "xla" or rounds_impl == "xla", sweep_impl=sweep_impl, rounds_impl=rounds_impl,
    )
    final = shadow_final_plain if final_impl == "xla" else shadow_final
    return final(z, ray_o, ray_d, sample_dist, inv_s, cos_anneal_ratio, weights, cfg)
