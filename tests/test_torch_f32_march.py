"""The f32 march weights (``march_dtype="float32"``) on the port's side of
the CPU: ``kernels/core_mlp.py::pack_sdf_mlp`` with an f32 dtype lays the
weights out as ``csrc/mma_rows.cuh::sdf_rows_f32`` reads them, and the
march wrappers pick each kernel's instance by the weights' dtype.  The f32
kernels themselves run on the card only (tests/test_torch_gpu.py,
``chip_smoke.py`` phase 14); on the CPU the wrappers run the plain f32
versions, which tests/test_torch_render.py and test_torch_train.py hold to
JAX at march_dtype="float32".

Exact: the f32 pack holds every weight unrounded at its layer's offset,
zero padding around it; the bf16 pack is that pack rounded to bf16 byte
for byte (what it was before the dtype existed: zeros, then each weight
rounded into place), with the same biases, head and meta.
"""
import numpy as np
import pytest
import torch

from nrhints_torch.fields.sdf import SDFNetConfig, _layer_dims, sdf_init
from nrhints_torch.kernels import core_mlp, march
from tests.torch_port_utils import SDF_KW

CFGS = {"tiny": SDFNetConfig(**SDF_KW), "full": SDFNetConfig()}


@pytest.mark.parametrize("name", sorted(CFGS))
def test_f32_pack_unpacks_to_the_weights(name):
    cfg = CFGS[name]
    p = sdf_init(torch.Generator().manual_seed(0), cfg, "cpu")
    w = march.march_weights(p, cfg, "float32")
    pk = core_mlp.pack_sdf_mlp(w, cfg, with_feat=False, dtype=torch.float32)
    assert pk["wpack"].dtype == torch.float32
    meta, (io, _) = pk["meta"], _layer_dims(cfg)
    seen = torch.zeros_like(pk["wpack"], dtype=torch.bool)
    for i, (din, dout) in enumerate(io):
        _, _, kp, np_, skip, w_off, _ = meta[10 + 7 * i: 17 + 7 * i]
        assert (kp, np_, skip) == (-(-din // 16) * 16, -(-dout // 16) * 16, int(i in cfg.skip_in))
        block = pk["wpack"][w_off: w_off + kp * np_].reshape(kp, np_)
        assert torch.equal(block[:din, :dout], w[2 * i])
        assert not block[din:].any() and not block[:, dout:].any()
        seen[w_off: w_off + kp * np_] = True
    assert bool(seen.all())
    assert torch.equal(pk["w_sdf"], w[-2].reshape(-1))


@pytest.mark.parametrize("name", sorted(CFGS))
def test_bf16_pack_is_the_f32_pack_rounded(name):
    cfg = CFGS[name]
    p = sdf_init(torch.Generator().manual_seed(1), cfg, "cpu")
    w = core_mlp.materialize_sdf_weights_full(p, cfg)  # with the feature head, as kernels A and D take it
    bf16 = core_mlp.pack_sdf_mlp(w, cfg, with_feat=True, dtype=torch.bfloat16)
    default = core_mlp.pack_sdf_mlp(w, cfg, with_feat=True)
    assert default["wpack"].dtype == bf16["wpack"].dtype == torch.bfloat16  # bf16 unless asked
    f32 = core_mlp.pack_sdf_mlp(w, cfg, with_feat=True, dtype=torch.float32)
    assert bf16["wpack"].view(torch.int16).numpy().tobytes() == \
        f32["wpack"].to(torch.bfloat16).view(torch.int16).numpy().tobytes()
    assert default["wpack"].view(torch.int16).numpy().tobytes() == bf16["wpack"].view(torch.int16).numpy().tobytes()
    for k in ("bpack", "w_sdf"):
        assert torch.equal(bf16[k], f32[k]), k
    np.testing.assert_array_equal(bf16["meta"], f32["meta"])
    with pytest.raises(ValueError, match="bf16 or f32"):
        core_mlp.pack_sdf_mlp(w, cfg, with_feat=False, dtype=torch.float16)


def test_march_instances_by_weight_dtype():
    """bf16 weights -> each kernel's bf16 entry point, f32 weights -> its
    ``_f32`` instance (counted under that name); other dtypes raise."""
    w16, w32 = [torch.zeros(2, 2, dtype=torch.bfloat16)], [torch.zeros(2, 2)]
    for fn in ("shadow_final", "march_sweep", "march_rounds", "importance_march", "shadow_march"):
        assert march._kernel_fn(fn, w16) == (fn, torch.bfloat16)
        assert march._kernel_fn(fn, w32) == (f"{fn}_f32", torch.float32)
        assert f"{fn}_f32" in march.cuda_lib.launch_counts
        assert f"{fn}_f32" in march.cuda_lib._SIGNATURES["march" if fn == "shadow_final" else "march_fused"]
    with pytest.raises(ValueError, match="bf16 or f32"):
        march._kernel_fn("march_sweep", [torch.zeros(2, 2, dtype=torch.float64)])
