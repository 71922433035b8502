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
    "src.models.autoencoder.latent.LatentAE": "deco_tpu_torch.models.autoencoders.LatentAE",
    "src.models.autoencoder.dc_latent.DCLatentAE": "deco_tpu_torch.models.autoencoders.DCLatentAE",
    "src.models.transformer.dit_c2i_baseline.FlattenDiT":
        "deco_tpu_torch.config.registry._baseline_dit",
    "src.models.transformer.dit_c2i_pixnerd.PixNerDiT": "deco_tpu_torch.config.registry._pixnerd_c2i",
    "src.models.transformer.dit_t2i_pixnerd.PixNerDiT": "deco_tpu_torch.config.registry._pixnerd_t2i",
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
    # training_repa's alignment branch is live upstream (unlike the DeCo
    # trainer's), so it maps to the trainer that computes it, as in JAX
    "src.diffusion.flow_matching.training_repa.REPATrainer":
        "deco_tpu_torch.diffusion.training.REPATrainer",
    "src.diffusion.flow_matching.training_repa_JiT.REPATrainer":
        "deco_tpu_torch.diffusion.training.JiTTrainer",
    "src.diffusion.ddpm.training.VPTrainer": "deco_tpu_torch.diffusion.training.VPTrainer",
    "src.diffusion.ddpm.training.DDPMTrainer": "deco_tpu_torch.diffusion.training.DDPMTrainer",
    "src.models.encoder.DINOv2": "deco_tpu_torch.models.encoders.DINOv2",
    "src.models.encoder.CLIP": "deco_tpu_torch.models.encoders.CLIP",
    "src.models.encoder.SigLIP": "deco_tpu_torch.models.encoders.SigLIP",
    "src.models.encoder.SigLIPVision": "deco_tpu_torch.models.encoders.SigLIPVision",
    "src.models.encoder_custom.DINOv2": "deco_tpu_torch.models.encoders.DINOv2",
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
    "src.data.dataset.imagenet.PixHFDataset": "deco_tpu_torch.data.imagenet.PixHFDataset",
    "src.data.dataset.imagenet.PixWebDataset": "deco_tpu_torch.data.webdataset.PixWebDataset",
    "src.data.dataset.imagenet.PixJSONLDataset": "deco_tpu_torch.data.jsonl.PixJSONLDataset",
    "src.data.dataset.imagenet.PixMultiJSONLDataset":
        "deco_tpu_torch.data.jsonl.PixMultiJSONLDataset",
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
    "src.models.transformer.encoder_ae_sim.VAEModel": "deco_tpu_torch.config.registry._vae_model_sim",
    "src.models.transformer.encoder_ae.VAEModel":
        "deco_tpu_torch.config.registry._vae_model_stochastic",
    "src.models.modules.vae_loss.VAEReconstructionLoss":
        "deco_tpu_torch.config.registry._VAELossConfig",
    "src.models.modules.discriminator.NLayerDiscriminator":
        "deco_tpu_torch.models.gan.discriminator.NLayerDiscriminator",
    "src.callbacks.simple_ema.SimpleEMA": "deco_tpu_torch.config.registry._SimpleEMAConfig",
    "torch.optim.AdamW": "deco_tpu_torch.config.registry._AdamWConfig",
}

# class path -> the ROADMAP section A item that ports it
UNPORTED: Dict[str, int] = {
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


def _dtypes(dtype, param_dtype) -> dict:
    return dict(dtype=torch_dtype(dtype),
                param_dtype=None if param_dtype is None else torch_dtype(param_dtype))


def _deco_c2i(dtype="bfloat16", param_dtype=None, **kw):
    """``DeCoC2I`` with the dtypes of a config (strings) as torch dtypes."""
    from deco_tpu_torch.models.dit_c2i_deco import DeCoC2I

    return DeCoC2I(**_dtypes(dtype, param_dtype), **kw)


def _baseline_dit(dtype="bfloat16", param_dtype=None, **kw):
    """``BaselineDiT`` with the dtypes of a config as torch dtypes."""
    from deco_tpu_torch.models.dit_c2i_baseline import BaselineDiT

    return BaselineDiT(**_dtypes(dtype, param_dtype), **kw)


def _pixnerd_c2i(dtype="bfloat16", param_dtype=None, **kw):
    """``PixNerdC2I`` with the dtypes of a config as torch dtypes."""
    from deco_tpu_torch.models.dit_c2i_pixnerd import PixNerdC2I

    return PixNerdC2I(**_dtypes(dtype, param_dtype), **kw)


def _pixnerd_t2i(dtype="bfloat16", param_dtype=None, **kw):
    """``PixNerdT2I`` with the dtypes of a config as torch dtypes."""
    from deco_tpu_torch.models.dit_t2i import PixNerdT2I

    return PixNerdT2I(**_dtypes(dtype, param_dtype), **kw)


def _dit_t2i_deco_dispatch(dtype="bfloat16", param_dtype=None, **kw):
    """The reference's ``dit_t2i_DeCo.PixNerDiT`` names two models: the
    config-implied t2i DeCo (``txt_*`` arguments), which is ``DeCoT2I``
    with the config's dtypes as torch dtypes, and the ReCo reconstruction
    model (``config_path``/``select_layer`` arguments): :func:`_reco`."""
    if "config_path" in kw or "select_layer" in kw:
        return _reco(dtype=dtype, param_dtype=param_dtype, **kw)
    from deco_tpu_torch.models.dit_t2i import DeCoT2I

    return DeCoT2I(**_dtypes(dtype, param_dtype), **kw)


# InternVL ``vision_config`` keys -> ``ViTConfig`` fields
_VISION_CONFIG_KEYS = (("hidden_size", "hidden_size"), ("num_hidden_layers", "num_layers"),
                       ("num_attention_heads", "num_heads"),
                       ("intermediate_size", "intermediate_size"), ("patch_size", "patch_size"),
                       ("image_size", "image_size"), ("qkv_bias", "qkv_bias"),
                       ("qk_normalization", "qk_normalization"), ("norm_type", "norm_type"))


def _reco(config_path=None, dtype="bfloat16", param_dtype=None, **kw):
    """``ReCoModel`` as the JAX dispatch builds it
    (``deco_tpu/config/registry.py`` ``_dit_t2i_deco_dispatch``): the
    tower's widths from ``<config_path>/config.json``'s ``vision_config``
    where that directory exists (an unreadable file keeps the defaults), else
    the InternViT defaults (qk normalisation, RMSNorm, initializer_factor
    0.1, ``ViTConfig``'s other fields); ``patch_size`` is dropped (the
    reference overwrites it with the tower's), and so is every argument
    ``ReCoModel`` does not take."""
    import dataclasses
    import inspect
    import json
    import os

    from deco_tpu_torch.models.reco import DEFAULT_VIT, ReCoModel

    vit_kw = {}
    if config_path and os.path.isdir(str(config_path)):
        try:
            with open(os.path.join(config_path, "config.json")) as f:
                vc = json.load(f).get("vision_config", {})
            vit_kw = {dst: vc[src] for src, dst in _VISION_CONFIG_KEYS if src in vc}
        except (OSError, ValueError):
            pass
    known = set(inspect.signature(ReCoModel).parameters) - {"vit", "dtype", "param_dtype"}
    return ReCoModel(vit=dataclasses.replace(DEFAULT_VIT, **vit_kw), **_dtypes(dtype, param_dtype),
                     **{k: v for k, v in kw.items() if k in known})


def _int_tuple(value, stages: int = 6) -> tuple:
    """A list, a comma-separated string ("8,16,32") or one int for every stage."""
    if isinstance(value, str):
        return tuple(int(v) for v in value.split(","))
    if isinstance(value, int):
        return (value,) * stages
    return tuple(int(v) for v in value)


# VAE node keys the port also reads (the JAX node drops them), so that a
# config or a command-line override can cut the widths: ViTConfig fields
# with a ``vit_`` prefix, and the VAEModel arguments below
_VAE_WIDTHS = ("gen_select_layer", "llm_hidden_size")


def _make_vae_model(stochastic: bool, encoder_config_path=None, decoder_weight_path=None,
                    decoder_subfolder=None, select_layer=-1, latent_channel=32,
                    load_pretrained_encoder=False, stage=None, dtype="bfloat16", device="cuda",
                    decoder_channels=None, decoder_layers=None, **kw):
    """The reference ``encoder_ae[_sim].VAEModel`` node -> ``VAEModel``
    (``deco_tpu/config/registry.py`` ``_make_vae_model``). The pretrained
    towers' paths are not read (no InternVL or DC-AE weights are in the
    repository: the run draws the parameters from its seed), with a warning
    where the node asks for them; ``select_layer`` and ``stage`` are read for
    the configs' sake (the generation tap is layer 18). ``vit_*`` keys,
    ``gen_select_layer``, ``llm_hidden_size``, ``decoder_channels`` and
    ``decoder_layers`` (a list, "a,b,c" or one int) set the widths."""
    import dataclasses
    import warnings

    from deco_tpu_torch.models.internvl import INTERNVIT
    from deco_tpu_torch.models.vae_models import VAEModel

    if load_pretrained_encoder and (encoder_config_path or decoder_weight_path):
        warnings.warn("pretrained encoder/decoder towers are not in the repository: the run "
                      "draws them from its seed (convert the weights and pass --ckpt_path)")
    vit = dataclasses.replace(INTERNVIT, **{k[4:]: v for k, v in kw.items()
                                            if k.startswith("vit_")})
    extra = {k: kw[k] for k in _VAE_WIDTHS if k in kw}
    if decoder_channels is not None:
        extra["decoder_channels"] = _int_tuple(decoder_channels)
    if decoder_layers is not None:
        extra["decoder_layers"] = _int_tuple(decoder_layers)
    return VAEModel(vit=vit, latent_channel=latent_channel, stochastic=stochastic,
                    dtype=torch_dtype(dtype), device=device, **extra)


def _vae_model_stochastic(**kw):
    return _make_vae_model(True, **kw)


def _vae_model_sim(**kw):
    return _make_vae_model(False, **kw)


class _VAELossConfig:
    """The reference ``VAEReconstructionLoss`` node -> ``VAEGANLoss`` settings
    (``loss_cfg``), the perceptual model's name (``perceptual_spec``), and
    the distillation teacher's path, which the run does not read (JAX's
    ``VAEGANRun`` has no teacher either, so the distillation term is 0)."""

    def __init__(self, discriminator_start: int = 0, discriminator_factor: float = 1.0,
                 discriminator_weight: float = 0.1, lecam_regularization_weight: float = 0.0,
                 perceptual_loss: str = None, perceptual_weight: float = 1.1,
                 reconstruction_loss: str = "l2", reconstruction_weight: float = 1.0,
                 kl_weight: float = 0.0, logvar_init: float = 0.0,
                 distillation_weight: float = 0.0, distillation_loss_type: str = "mse",
                 teacher_model_path: str = None, select_layer: int = -1,
                 downsample_ratio: float = 0.5, use_rotation_aug: bool = False, **kw):
        from deco_tpu_torch.models.gan.vae_loss import VAEGANLoss

        self.loss_cfg = VAEGANLoss(
            reconstruction_loss=reconstruction_loss, reconstruction_weight=reconstruction_weight,
            perceptual_weight=perceptual_weight, discriminator_weight=discriminator_weight,
            discriminator_factor=discriminator_factor,
            discriminator_iter_start=discriminator_start,
            lecam_regularization_weight=lecam_regularization_weight,
            distillation_weight=distillation_weight,
            distillation_loss_type=distillation_loss_type, kl_weight=kl_weight,
            logvar_init=logvar_init)
        self.perceptual_spec = perceptual_loss
        self.teacher_model_path = teacher_model_path
        self.use_rotation_aug = use_rotation_aug


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

    def create_state(self, model, trainer_module=None):
        """A :class:`~deco_tpu_torch.train.state.TrainState` (with EMA) over
        ``model`` and the trainer's own parameters (``trainer_module``)."""
        from deco_tpu_torch.train.state import TrainState

        return TrainState.create(model, lr=self.lr, weight_decay=self.weight_decay,
                                 betas=self.betas, eps=self.eps, trainer_module=trainer_module)


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
# ... except where the weights are the node's own: the frozen REPA encoders
# read their published weights from weight_path (null draws a random DINOv2)
KEPT_ARGS = {cp: {"weight_path"} for cp in (
    "src.models.encoder.DINOv2", "src.models.encoder_custom.DINOv2", "src.models.encoder.CLIP",
    "src.models.encoder.SigLIP", "src.models.encoder.SigLIPVision")}
RENAMED_ARGS = {"grad_checkpointing": "grad_checkpoint"}


class Deferred:
    """A ``class_path`` node built at its first call, for an init argument
    that its object stores and may never call: the class names such
    arguments in ``deferred_args`` (``DeCoTrainer``'s REPA ``encoder``, whose
    DINOv2 tower the DeCo objective never runs). Until then nothing is
    built, no weight file is read and nothing lands on a device."""

    def __init__(self, node: dict, drop_unknown: bool = True):
        self.node = node
        self.drop_unknown = drop_unknown
        self.built = None

    def build(self):
        if self.built is None:
            self.built = instantiate(self.node, self.drop_unknown)
        return self.built

    def __call__(self, *args, **kwargs):
        return self.build()(*args, **kwargs)


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
        deferred = getattr(cls, "deferred_args", ())
        kwargs = {}
        for k, v in (node.get("init_args") or {}).items():
            if drop_unknown and k in DROPPED_ARGS and k not in KEPT_ARGS.get(
                    node["class_path"], ()):
                continue
            if k in deferred and isinstance(v, dict) and "class_path" in v:
                kwargs[k] = Deferred(v, drop_unknown)
            else:
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
