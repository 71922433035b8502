"""The port's weight bridge (deco_tpu_torch.convert) against the JAX package's
exporter, and the port's import boundary."""

import pathlib
import re

import jax
import numpy as np
import torch

from deco_tpu.convert.flax_to_torch import export_deco_c2i, save_torch_checkpoint
from deco_tpu_torch.convert import load_checkpoint, state_dict_from_jax
from deco_tpu_torch.models.dit_c2i_deco import DeCoC2I
from torch_port_util import TINY_C2I, tiny_jax_c2i

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _np_params(seed=0):
    _, params = tiny_jax_c2i(seed)
    return jax.tree_util.tree_map(np.asarray, params)


def test_state_dict_equals_reference_export():
    params = _np_params()
    ref = export_deco_c2i(params, in_channels=3, patch_size=TINY_C2I["patch_size"], prefix="")
    sd = state_dict_from_jax(params, in_channels=3, patch_size=TINY_C2I["patch_size"])
    assert sorted(sd) == sorted(ref)
    for key, value in ref.items():
        assert sd[key].dtype == torch.float32
        np.testing.assert_array_equal(sd[key].numpy(), value, err_msg=key)


def test_port_model_loads_strict_with_channel_major_s_embedder():
    params = _np_params()
    model = DeCoC2I(**TINY_C2I, dtype=torch.float32, device="cpu")
    model.load_state_dict(
        state_dict_from_jax(params, in_channels=3, patch_size=TINY_C2I["patch_size"]),
        strict=True)
    # torch-unfold order: input column c*P^2 + pixel holds pixel-major row pixel*C + c
    kernel = params["params"]["s_embedder"]["proj"]["kernel"]
    weight = model.s_embedder.proj.weight.detach().numpy()
    p2 = TINY_C2I["patch_size"] ** 2
    np.testing.assert_array_equal(weight[:, 1 * p2 + 5], kernel[5 * 3 + 1])


def test_reference_checkpoint_file_loads(tmp_path):
    """A ``.pt`` written by the JAX package's exporter (denoiser.* and
    ema_denoiser.* keys) loads into the port; EMA weights are preferred."""
    params, ema = _np_params(0), _np_params(1)
    from deco_tpu.convert.flax_to_torch import export_checkpoint

    path = str(tmp_path / "ckpt.pt")
    save_torch_checkpoint(export_checkpoint(params, ema, patch_size=TINY_C2I["patch_size"]), path)
    model = DeCoC2I(**TINY_C2I, dtype=torch.float32, device="cpu")
    model.load_state_dict(load_checkpoint(path), strict=True)
    expected = state_dict_from_jax(ema, patch_size=TINY_C2I["patch_size"])
    for key, value in model.state_dict().items():
        torch.testing.assert_close(value, expected[key], rtol=0, atol=0)


def test_port_sources_import_no_jax():
    """The port runs on a host without JAX: no module of deco_tpu_torch and
    not chip_smoke.py imports jax, flax, optax, orbax, the JAX package, or
    PyYAML and PIL (which that host lacks too)."""
    pattern = re.compile(r"^\s*(import|from)\s+(jax|flax|optax|orbax|deco_tpu|yaml|PIL)\b", re.M)
    files = sorted((ROOT / "deco_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    offenders = [str(f.relative_to(ROOT)) for f in files if pattern.search(f.read_text())]
    assert offenders == []
