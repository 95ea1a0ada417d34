"""Shared set-up of the port's tests (tests/test_torch_*.py): tiny configs
that keep the full model's structure (a skip connection, both hints), the
same numpy-seeded inputs for the JAX package and the port, and the
conversion of JAX parameter trees.  JAX stays on the CPU (tests/conftest.py)."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from nrhints_torch.convert import params_from_jax

# 4 x 32 SDF MLP with a skip at layer 2 (multi_res=4 keeps the 27-wide
# encoding narrower than the hidden width), 16-wide feature, 2 x 32 trunk.
SDF_KW = dict(n_layers=4, d_hidden=32, d_out_feat=16, skip_in=(2,), multi_res=4)
REFL_KW = dict(n_layers=2, d_hidden=32)
N_RAYS = 24  # not a multiple of any block size of either package


def to_torch(a) -> torch.Tensor:
    return torch.as_tensor(np.array(np.asarray(a)))


def jax_sdf_params(seed: int = 0):
    """(JAX config, JAX params as numpy, the port's config, port params)."""
    from nrhints_torch.fields.sdf import SDFNetConfig as TS
    from nrhints_tpu.fields.sdf import SDFNetConfig as JS, sdf_init

    jc = JS(**SDF_KW)
    jp = jax.device_get(sdf_init(jax.random.PRNGKey(seed), jc))
    return jc, jp, TS(**SDF_KW), params_from_jax(jp, device="cpu")


def model_configs(**renderer_kw):
    """(JAX ModelConfig on its fused interpret-mode path, port ModelConfig)."""
    from nrhints_torch.fields.reflectance import ReflectanceNetConfig as TR
    from nrhints_torch.fields.sdf import SDFNetConfig as TS
    from nrhints_torch.render import renderer as tr
    from nrhints_tpu.fields.reflectance import ReflectanceNetConfig as JR
    from nrhints_tpu.fields.sdf import SDFNetConfig as JS
    from nrhints_tpu.render import renderer as jr

    j = jr.ModelConfig(
        sdf_network=JS(**SDF_KW),
        reflectance_network=JR(**REFL_KW),
        renderer=jr.RendererConfig(fused_kernels="on", fused_interpret=True, **renderer_kw),
    )
    t = tr.ModelConfig(
        sdf_network=TS(**SDF_KW),
        reflectance_network=TR(**REFL_KW),
        renderer=tr.RendererConfig(**renderer_kw),
    )
    return j, t


def model_params(jcfg, seed: int = 0):
    """JAX init_model_params as numpy (colour weights x4 so the rendered
    colours are not all near 0.5), and the same tree as torch tensors."""
    from nrhints_tpu.render.renderer import init_model_params

    jp = jax.device_get(init_model_params(jax.random.PRNGKey(seed), jcfg))
    jp["color"] = jax.tree_util.tree_map(lambda x: np.asarray(x) * 4.0, jp["color"])
    return jp, params_from_jax(jp, device="cpu")


def camera_rays(seed: int = 0, n: int = N_RAYS):
    """Rays from a camera at radius ~2.7 through the SAL sphere (radius
    0.5), each with its own light on a sphere of radius 3.2, so some shadow
    rays pass through the sphere: (o, d, pl, near, far) as float32 numpy."""
    rng = np.random.default_rng(seed)
    o = np.tile(np.array([[0.3, 0.4, -2.7]], np.float32), (n, 1))
    tgt = rng.uniform(-0.6, 0.6, (n, 3)).astype(np.float32)
    tgt[:, 2] = 0.0
    d = tgt - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    pl = rng.normal(size=(n, 3)).astype(np.float32)
    pl = 3.2 * pl / np.linalg.norm(pl, axis=-1, keepdims=True)
    mid = -np.sum(o * d, -1, keepdims=True)
    return o, d, pl.astype(np.float32), (mid - 1.0).astype(np.float32), (mid + 1.0).astype(np.float32)


def ray_bundles(seed: int = 0, n: int = N_RAYS):
    """The same rays as a JAX and a port RayBundle."""
    from nrhints_torch.core.structs import RayBundle as TRB
    from nrhints_tpu.core.structs import RayBundle as JRB

    arrs = camera_rays(seed, n)
    return JRB(*[jnp.asarray(a) for a in arrs]), TRB(*[torch.as_tensor(a) for a in arrs])
