"""The port's classification slice (fastvim_tpu_torch.models) against the
JAX package's VisionMamba, on the CPU, and the weight carry between them.

Small models (embed 64, depth 2, 10 classes) keep the full structure:
patch embed, pos embed, rotated odd layers, fused or unfused mixers, final
norm, pool and head. The JAX side runs once with the fused layer and the
Pallas scan (all three kernels interpreted) and once unfused with the
sequential reference scan. Tolerance on logits: rtol = atol = 1e-4 in
fp32 — each side sums the same fp32 terms in another order (GEMMs,
convs, norms), a few 1e-6 per layer, and 1e-4 leaves room for the depth.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastvim_tpu.models import create_model as jax_create_model
from fastvim_tpu.models import list_models as jax_list_models
from fastvim_tpu.utils.torch_convert import export_vision_mamba
from fastvim_tpu_torch.models import create_model, list_models
from fastvim_tpu_torch.utils import from_jax_params

TOL = dict(rtol=1e-4, atol=1e-4)
SMALL = dict(patch_size=16, depth=2, embed_dim=64, num_classes=10,
             drop_path_rate=0.0)
PORT = dict(SMALL, device="cpu")  # the port builds on the card unless asked


def _jax_model(name, img_size, **kw):
    model = jax_create_model(name, img_size=img_size, **SMALL, **kw)
    hw = img_size if isinstance(img_size, tuple) else (img_size, img_size)
    x = np.random.default_rng(0).standard_normal(
        (2, *hw, 3)).astype(np.float32)
    params = model.init(jax.random.PRNGKey(1), jnp.asarray(x))
    return model, params, x


def _port_model(name, img_size, params, **kw):
    model = create_model(name, img_size=img_size, **PORT, **kw)
    sd = {k: torch.from_numpy(np.array(v))
          for k, v in from_jax_params(params).items()}
    model.load_state_dict(sd, strict=True)
    return model


def _logits(model, x):
    with torch.no_grad():
        return model(torch.from_numpy(x)).numpy()


def test_from_jax_params_matches_export():
    """from_jax_params equals the JAX package's export_vision_mamba key
    for key, and its keys are exactly the port model's state_dict."""
    for name in ("fastvim_tiny", "vim_tiny_midclstok"):
        _, params, _ = _jax_model(name, 64)
        got = from_jax_params(params)
        want = export_vision_mamba(params)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        port = create_model(name, img_size=64, **PORT)
        assert sorted(port.state_dict()) == sorted(got)
        for k, v in port.state_dict().items():
            assert tuple(v.shape) == got[k].shape, k


@pytest.mark.parametrize("name,img_size,extra", [
    ("fastvim_tiny", 128, {}),          # 8×8 grid: fused on both sides
    ("fastvim_tiny", (96, 160), {}),    # 6×10: fused in the port only
    ("fastvim_tiny", (96, 160),         # column-major raster: 10×6 grid
     {"scanpath_type": "colwise"}),
    ("vim_tiny", 64, {}),               # full scans, materialized rotation
    ("vim_tiny_midclstok", 64, {}),     # full scans, middle cls token
])
@pytest.mark.parametrize("jax_path", ["fused_pallas", "unfused_ref"])
def test_logits_match_jax(name, img_size, extra, jax_path):
    kw = (dict(layer_fused="on", scan_impl="pallas")
          if jax_path == "fused_pallas"
          else dict(layer_fused="off", scan_impl="ref"))
    jmodel, params, x = _jax_model(name, img_size, **kw, **extra)
    want = np.asarray(jmodel.apply(params, jnp.asarray(x)))
    got = _logits(_port_model(name, img_size, params, **extra), x)
    assert got.shape == (2, 10)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("field,value", [("layer_fused", "off"),
                                         ("scan_impl", "ref")])
def test_dispatch_fields_agree(field, value):
    """The mixer's unfused path and the forced reference scan give the
    logits of the default dispatch (fused layer, device-dispatched scan)."""
    a = create_model("fastvim_tiny", img_size=128, **PORT)
    b = create_model("fastvim_tiny", img_size=128, **PORT, **{field: value})
    x = np.random.default_rng(2).standard_normal(
        (2, 128, 128, 3)).astype(np.float32)
    np.testing.assert_allclose(_logits(b, x), _logits(a, x), **TOL)


def test_seeded_init_and_registry():
    """One generator seed gives one model; every port name exists in the
    JAX registry."""
    g = lambda: torch.Generator().manual_seed(7)
    a = create_model("fastvim_tiny", img_size=64, generator=g(), **PORT)
    b = create_model("fastvim_tiny", img_size=64, generator=g(), **PORT)
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    assert not a.training
    names = set(list_models())
    assert {"fastvim_tiny", "vim_tiny", "vim_tiny_midclstok",
            "fastvim_huge"} <= names
    assert names <= set(jax_list_models())


def test_grid_mismatch_raises():
    """Another grid than img_size's resizes the pos-embed (held against
    the JAX package in tests/test_torch_port_data.py); a cls-token model
    takes its training grid only, as the JAX package's does."""
    x = torch.zeros(1, 96, 64, 3)
    assert create_model("fastvim_tiny", img_size=64, **PORT)(x).shape == \
        (1, 10)
    model = create_model("vim_tiny_midclstok", img_size=64, **PORT)
    with pytest.raises(ValueError, match="training grid"):
        model(x)
