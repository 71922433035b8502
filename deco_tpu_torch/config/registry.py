"""YAML config surface: ``class_path``/``init_args`` instantiation
(``deco_tpu/config/registry.py``).

Every object of a run config is a ``class_path``/``init_args`` node,
instantiated recursively. :data:`REFERENCE_CLASS_MAP` has the JAX
registry's keys (the reference's torch class paths): the ported ones map to
``deco_tpu_torch`` classes, and every other one to a factory that raises
``NotImplementedError`` naming the ROADMAP item that ports it. Step
functions collapse to string selectors through :data:`VALUE_MAP`.
:func:`apply_overrides` applies ``--a.b.c=v`` dot-overrides.

Departure from the JAX package: PyYAML reads ``lr: 1e-4`` as the string
``'1e-4'`` (YAML 1.1 floats need a dot), and the JAX AdamW node hands the
string to optax, which fails at its first update. The reference's config
system casts by type hint, so the port's optimizer node turns numeric
strings into floats.
"""

from __future__ import annotations

import importlib
from typing import Any, Callable, Dict, Union

import torch

from deco_tpu_torch.config import _yaml

_PORTED: Dict[str, str] = {
    "src.models.autoencoder.pixel.PixelAE": "deco_tpu_torch.models.autoencoders.PixelAE",
    "src.models.transformer.dit_c2i_DeCo.PixNerDiT": "deco_tpu_torch.config.registry._deco_c2i",
    "src.models.transformer.dit_t2i_DeCo.PixNerDiT":
        "deco_tpu_torch.config.registry._dit_t2i_deco_dispatch",
    "src.models.conditioner.class_label.LabelConditioner":
        "deco_tpu_torch.models.conditioners.LabelConditioner",
    "src.models.conditioner.qwen3_text_encoder.Qwen3TextEncoder":
        "deco_tpu_torch.models.conditioners.Qwen3TextEncoder",
    "src.models.conditioner.place_holder.PlaceHolderConditioner":
        "deco_tpu_torch.models.conditioners.PlaceHolderConditioner",
    "src.models.conditioner.base.ComposeConditioner":
        "deco_tpu_torch.models.conditioners.ComposeConditioner",
    "src.diffusion.flow_matching.scheduling.LinearScheduler":
        "deco_tpu_torch.diffusion.scheduling.LinearScheduler",
    "src.diffusion.flow_matching.training.FlowMatchingTrainer":
        "deco_tpu_torch.diffusion.training.FlowMatchingTrainer",
    "src.diffusion.flow_matching.training_repa_DeCo.REPATrainer":
        "deco_tpu_torch.diffusion.training.DeCoTrainer",
    "src.diffusion.flow_matching.scheduling.GVPScheduler":
        "deco_tpu_torch.diffusion.scheduling.GVPScheduler",
    "src.diffusion.flow_matching.scheduling.ConstScheduler":
        "deco_tpu_torch.diffusion.scheduling.ConstScheduler",
    "src.diffusion.flow_matching.scheduling.VPBetaScheduler":
        "deco_tpu_torch.diffusion.scheduling.VPBetaScheduler",
    "src.diffusion.ddpm.scheduling.VPScheduler": "deco_tpu_torch.diffusion.scheduling.VPScheduler",
    "src.diffusion.ddpm.scheduling.DDPMScheduler":
        "deco_tpu_torch.diffusion.scheduling.DDPMScheduler",
    "src.diffusion.flow_matching.sampling.EulerSampler":
        "deco_tpu_torch.diffusion.sampling.EulerSampler",
    "src.diffusion.flow_matching.sampling.EulerSamplerJiT":
        "deco_tpu_torch.diffusion.sampling.EulerSamplerJiT",
    "src.diffusion.flow_matching.sampling.HeunSampler":
        "deco_tpu_torch.diffusion.sampling.HeunSampler",
    "src.diffusion.flow_matching.adam_sampling.AdamLMSampler":
        "deco_tpu_torch.diffusion.adam_sampling.AdamLMSampler",
    "src.diffusion.ddpm.ddim_sampling.DDIMSampler":
        "deco_tpu_torch.diffusion.ddpm_sampling.DDIMSampler",
    "src.diffusion.ddpm.vp_sampling.VPEulerSampler":
        "deco_tpu_torch.diffusion.ddpm_sampling.VPEulerSampler",
    "src.diffusion.base.guidance.simple_guidance_fn":
        "deco_tpu_torch.diffusion.guidance.simple_guidance_fn",
    "src.diffusion.base.guidance.guidance_fn_with_rescale":
        "deco_tpu_torch.diffusion.guidance.guidance_fn_with_rescale",
    "src.diffusion.base.guidance.c3_guidance_fn": "deco_tpu_torch.diffusion.guidance.c3_guidance_fn",
    "src.data.dataset.imagenet.PixImageNet": "deco_tpu_torch.data.imagenet.PixImageNet",
    "src.data.dataset.randn.RandomNDataset": "deco_tpu_torch.data.randn.RandomNDataset",
    "src.data.dataset.randn.ClassLabelRandomNDataset":
        "deco_tpu_torch.data.randn.ClassLabelRandomNDataset",
    "src.data.dataset.geneval.GenEvalDataset": "deco_tpu_torch.data.geneval.GenEvalDataset",
    "src.data.dataset.dpg.DPGDataset": "deco_tpu_torch.data.dpg.DPGDataset",
    "src.data.dataset.image_txt.ImageText": "deco_tpu_torch.data.image_txt.ImageText",
    "src.data.dataset.blip3o_dataset.PackedParquetDataset":
        "deco_tpu_torch.data.packed.PackedParquetDataset",
    "src.data.dataset.blip3o_dataset.WebDatasetPackedDataset":
        "deco_tpu_torch.data.packed.WebDatasetPacked",
    "src.callbacks.simple_ema.SimpleEMA": "deco_tpu_torch.config.registry._SimpleEMAConfig",
    "torch.optim.AdamW": "deco_tpu_torch.config.registry._AdamWConfig",
}

# class path -> the ROADMAP section A item that ports it
UNPORTED: Dict[str, int] = {
    "src.models.autoencoder.latent.LatentAE": 4,
    "src.models.autoencoder.dc_latent.DCLatentAE": 4,
    "src.models.transformer.dit_c2i_baseline.FlattenDiT": 4,
    "src.models.transformer.dit_c2i_pixnerd.PixNerDiT": 4,
    "src.models.transformer.dit_t2i_pixnerd.PixNerDiT": 4,
    "src.diffusion.flow_matching.training_repa.REPATrainer": 4,
    "src.diffusion.flow_matching.training_repa_JiT.REPATrainer": 4,
    "src.diffusion.ddpm.training.VPTrainer": 4,
    "src.diffusion.ddpm.training.DDPMTrainer": 4,
    "src.models.encoder.DINOv2": 4,
    "src.models.encoder.CLIP": 4,
    "src.models.encoder.SigLIP": 4,
    "src.models.encoder.SigLIPVision": 4,
    "src.models.encoder_custom.DINOv2": 4,
    "src.models.transformer.encoder_ae_sim.VAEModel": 5,
    "src.models.transformer.encoder_ae.VAEModel": 5,
    "src.models.modules.vae_loss.VAEReconstructionLoss": 5,
    "src.models.modules.discriminator.NLayerDiscriminator": 5,
    "src.data.dataset.imagenet.PixHFDataset": 2,
    "src.data.dataset.imagenet.PixWebDataset": 2,
    "src.data.dataset.imagenet.PixJSONLDataset": 2,
    "src.data.dataset.imagenet.PixMultiJSONLDataset": 2,
    "src.data.dataset.blip3o_ori_dataset.LazySupervisedMixDataset": 5,
    "src.models.modules.losses.ReconstructionLoss_Base": 5,
    "src.models.modules.losses.ReconstructionLoss_Stage1": 5,
    "src.models.modules.losses.ReconstructionLoss_Stage2": 5,
    "optax.adafactor": 7,
    "transformers.Adafactor": 7,
}


def not_ported(class_path: str, item: int) -> NotImplementedError:
    return NotImplementedError(f"{class_path}: not ported to deco_tpu_torch yet, ROADMAP §A {item}")


def _unported_factory(class_path: str, item: int) -> Callable:
    def factory(*args, **kwargs):
        raise not_ported(class_path, item)

    factory.__name__ = f"unported<{class_path}>"
    return factory


REFERENCE_CLASS_MAP: Dict[str, Union[str, Callable]] = {
    **_PORTED, **{cp: _unported_factory(cp, item) for cp, item in UNPORTED.items()}}

VALUE_MAP: Dict[str, str] = {
    "src.diffusion.flow_matching.sampling.ode_step_fn": "ode",
    "src.diffusion.flow_matching.sampling.sde_step_fn": "sde",
    "src.diffusion.flow_matching.sampling.sde_mean_step_fn": "sde_mean",
    "src.diffusion.flow_matching.sampling.sde_preserve_step_fn": "sde_preserve",
    "src.diffusion.flow_matching.adam_sampling.ode_step_fn": "ode",
    "src.diffusion.flow_matching.adam_sampling.t2snr": "snr",
    "src.diffusion.flow_matching.adam_sampling.t2logsnr": "logsnr",
    "src.diffusion.flow_matching.adam_sampling.t2isnr": "isnr",
    "src.diffusion.flow_matching.adam_sampling.nop": "nop",
}

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def torch_dtype(value):
    """A dtype given in a config (``bfloat16``, ``jnp.float32``, ...) as a torch dtype."""
    if isinstance(value, torch.dtype):
        return value
    name = str(value).rsplit(".", 1)[-1]
    if name not in _DTYPES:
        raise ValueError(f"dtype {value!r}: expected one of {sorted(_DTYPES)}")
    return _DTYPES[name]


def _deco_c2i(dtype="bfloat16", param_dtype=None, **kw):
    """``DeCoC2I`` with the dtypes of a config (strings) as torch dtypes."""
    from deco_tpu_torch.models.dit_c2i_deco import DeCoC2I

    return DeCoC2I(dtype=torch_dtype(dtype),
                   param_dtype=None if param_dtype is None else torch_dtype(param_dtype), **kw)


def _dit_t2i_deco_dispatch(dtype="bfloat16", param_dtype=None, **kw):
    """The reference's ``dit_t2i_DeCo.PixNerDiT`` names two models: the
    config-implied t2i DeCo (``txt_*`` arguments), which is ``DeCoT2I``
    with the config's dtypes as torch dtypes, and the ReCo reconstruction
    model (``config_path``/``select_layer`` arguments), which is not ported."""
    if "config_path" in kw or "select_layer" in kw:
        raise not_ported("src.models.transformer.dit_t2i_DeCo.PixNerDiT (the ReCo model: "
                         "config_path/select_layer)", 5)
    from deco_tpu_torch.models.dit_t2i import DeCoT2I

    return DeCoT2I(dtype=torch_dtype(dtype),
                   param_dtype=None if param_dtype is None else torch_dtype(param_dtype), **kw)


# the settings nodes below take float() of numbers given as strings: YAML 1.1
# reads 1e-4 as the string '1e-4'


class _SimpleEMAConfig:
    """EMA settings node (reference SimpleEMA callback args)."""

    def __init__(self, decay: float = 0.9999, every_n_steps: int = 1):
        self.decay = float(decay)
        self.every_n_steps = int(every_n_steps)


class _AdamWConfig:
    """Optimizer settings node -> torch AdamW over a model's parameters.

    Numeric strings become floats (see the module docstring)."""

    def __init__(self, lr: float = 1e-4, weight_decay: float = 0.0, betas=(0.9, 0.999),
                 eps: float = 1e-8):
        self.lr = float(lr)
        self.weight_decay = float(weight_decay)
        self.betas = tuple(float(b) for b in betas)
        self.eps = float(eps)

    def create_state(self, model):
        """A :class:`~deco_tpu_torch.train.state.TrainState` (with EMA) over ``model``."""
        from deco_tpu_torch.train.state import TrainState

        return TrainState.create(model, lr=self.lr, weight_decay=self.weight_decay,
                                 betas=self.betas, eps=self.eps)


def resolve(class_path: str):
    """The class or callable a (reference or ``deco_tpu_torch``) class path names."""
    target = REFERENCE_CLASS_MAP.get(class_path, class_path)
    if callable(target):
        return target
    if not target.startswith("deco_tpu_torch."):
        raise ValueError(f"class path {class_path!r}: not a reference class path the port "
                         "knows, nor a deco_tpu_torch path")
    module_name, _, attr = target.rpartition(".")
    return getattr(importlib.import_module(module_name), attr)


# init_args accepted by reference classes and dropped on purpose: weight
# loading goes through the checkpoint, and the rest are torch-runtime flags
# with no counterpart in these models
DROPPED_ARGS = {"weight_path", "load_ema", "learn_sigma", "deep_supervision", "attn_drop",
                "proj_drop", "qkv_bias"}
RENAMED_ARGS = {"grad_checkpointing": "grad_checkpoint"}


def instantiate(node: Any, drop_unknown: bool = True):
    """Recursively instantiate a ``class_path``/``init_args`` config tree."""
    if isinstance(node, str):
        if node in VALUE_MAP:
            return VALUE_MAP[node]
        if node in REFERENCE_CLASS_MAP or node.startswith(("deco_tpu_torch.", "src.")):
            if node.startswith("src.") and node not in REFERENCE_CLASS_MAP:
                raise ValueError(f"class path {node!r}: not in the reference class map")
            target = resolve(node)
            # a bare class path string is a default-constructed instance
            return target() if isinstance(target, type) else target
        return node
    if isinstance(node, list):
        return [instantiate(n, drop_unknown) for n in node]
    if not isinstance(node, dict):
        return node
    if "class_path" in node:
        cls = resolve(node["class_path"])
        kwargs = {}
        for k, v in (node.get("init_args") or {}).items():
            if drop_unknown and k in DROPPED_ARGS:
                continue
            kwargs[RENAMED_ARGS.get(k, k)] = instantiate(v, drop_unknown)
        return cls(**kwargs)
    return {k: instantiate(v, drop_unknown) for k, v in node.items()}


def apply_overrides(config: dict, overrides: Dict[str, Any]) -> dict:
    """Apply dot-path overrides (``model.denoiser.init_args.foo=1``) in place."""
    for path, value in overrides.items():
        parts = path.split(".")
        node = config
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return config


def load_yaml(path: str) -> dict:
    return _yaml.load(path)
