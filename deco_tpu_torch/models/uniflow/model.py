"""UniFlow, the unified understanding-and-generation tokenizer
(``deco_tpu/models/uniflow/model.py``).

:class:`UniFlowVision` is the reference ``UniFlowVisionModel``:

- a 24-layer InternViT (``embeddings``, ``encoder``) and a 4-layer shallow
  one (``shallow_embeddings``, ``shallow_encoder``) over the ImageNet
  normalisation of ``x * 0.5 + 0.5``, class tokens dropped;
- :class:`~deco_tpu_torch.models.uniflow.components.LatentProjector`, the
  deep tokens gated by the shallow ones, then a parameter-free layer norm
  (eps 1e-5): the 256-channel latent at half the ViT grid;
- the semantic branch: ``sem_latent_proj``, the sincos position embedding
  (cubic-resized to the grid), six causal
  :class:`~deco_tpu_torch.models.uniflow.components.PlainDiTBlock`\\ s at
  width 2 x vh (32 heads) with the extrapolating RoPE table over [0, grid],
  and ``sem_flow_head`` (width 2,048, 4 blocks) reconstructing the
  x0.5-shuffled ViT tokens after a parameter-free layer norm with eps 0;
  ``mlp1`` of its prediction is distilled towards ``mlp1`` of the ViT
  tokens (or a teacher's);
- the pixel branch: the latent shuffled x2, ``gen_latent_proj``, the
  position embedding, six ``PlainDiTBlock``\\ s at width vh (16 heads) and
  ``flow_head``, one token a ViT patch; or, with ``decoder_type: dcae``,
  ``gen_latent_proj`` to ``latent_ch`` channels, the headless DC-AE decoder
  (:class:`~deco_tpu_torch.models.dcae.DCAEDecoder`), a bilinear resize to
  the image and a per-pixel flow head.

``forward_loss`` gives ``distill_loss``, ``vit_distill_loss``,
``sem_mse_loss``, ``flow_loss`` and ``lpips_loss`` (0 without an
``lpips_fn``) and their sum ``loss``; ``forward`` reconstructs in the
``pixel`` or ``semantic`` mode. The model computes in ``dtype`` (bf16) with
fp32 parameters; the flow heads' targets are fp32. Module names are the
reference state-dict keys (``convert.state_dict_from_jax_uniflow`` writes
them).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

from deco_tpu_torch._device import resolve_device
from deco_tpu_torch.models import layers as L
from deco_tpu_torch.models.encoders import IMAGENET_MEAN, IMAGENET_STD
from deco_tpu_torch.models.uniflow import components as C
from deco_tpu_torch.models.uniflow import vit as vit_lib
from deco_tpu_torch.models.uniflow.flow_decoder import FlowDecoder

CONFIG_JSON = os.path.join(os.path.dirname(os.path.abspath(__file__)), "config.json")


@dataclasses.dataclass(frozen=True)
class UniFlowConfig:
    """The reference ``UniFlowVisionConfig`` surface: every key of
    ``config.json`` (``num_sampling_steps`` is the string ``"4"`` there and
    is made an int), and the DC-AE pixel branch's geometry."""

    vit_hidden_size: int = 1024
    llm_hidden_size: int = 1536
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    intermediate_size: int = 4096
    patch_size: int = 14
    image_size: int = 448
    latent_ch: int = 32
    global_blocks_depth: int = 6
    num_decoder_layers: int = 12
    num_sampling_steps: int = 4
    qkv_bias: bool = True
    qk_normalization: bool = False
    norm_type: str = "layer_norm"
    enable_semantic_branch: bool = True
    enable_pixel_branch: bool = True
    # accepted for the reference config's sake; the model does not read them
    num_channels: int = 3
    hidden_act: str = "gelu"
    layer_norm_eps: float = 1e-6
    dropout: float = 0.0
    drop_path_rate: float = 0.0
    attention_dropout: float = 0.0
    initializer_range: float = 0.02
    initializer_factor: float = 0.1
    use_flash_attn: bool = True
    use_global_blocks: bool = True
    use_cfg: bool = False
    use_disp_loss: bool = False
    use_chal_proj: bool = True
    decoder_type: str = "mlp"
    compression_layers: tuple = (-1, 4)
    num_query_per_layer: tuple = (64, 191)
    # decoder_type "dcae": the Sana-600M DC-AE decoder and a per-pixel flow head
    dcae_block_out_channels: tuple = (128, 256, 512, 512, 1024, 1024)
    dcae_layers_per_block: tuple = (3, 3, 3, 3, 3, 3)
    dcae_attention_stages: tuple = (False, False, False, True, True, True)
    dcae_flow_width: int = 64
    dcae_flow_depth: int = 6

    def __post_init__(self):
        object.__setattr__(self, "num_sampling_steps", int(self.num_sampling_steps))
        for k in ("compression_layers", "num_query_per_layer", "dcae_block_out_channels",
                  "dcae_layers_per_block", "dcae_attention_stages"):
            object.__setattr__(self, k, tuple(getattr(self, k)))

    @classmethod
    def from_dict(cls, d: dict) -> "UniFlowConfig":
        """From a reference config dict: a ``vision_config`` sub-dict is
        unwrapped, ``hidden_size`` stands in for a missing
        ``vit_hidden_size``, unknown keys are ignored."""
        if "vision_config" in d:
            d = d["vision_config"]
        d = dict(d)
        if "hidden_size" in d and "vit_hidden_size" not in d:
            d["vit_hidden_size"] = d["hidden_size"]
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    @classmethod
    def from_pretrained(cls, path: str = CONFIG_JSON) -> "UniFlowConfig":
        """From a config.json file or a directory holding one."""
        if os.path.isdir(path):
            path = os.path.join(path, "config.json")
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        for k in ("compression_layers", "num_query_per_layer"):
            d[k] = list(d[k])
        return d

    def vit(self, num_layers: Optional[int] = None) -> vit_lib.ViTConfig:
        return vit_lib.ViTConfig(
            hidden_size=self.vit_hidden_size, num_layers=num_layers or self.num_hidden_layers,
            num_heads=self.num_attention_heads, intermediate_size=self.intermediate_size,
            patch_size=self.patch_size, image_size=self.image_size, qkv_bias=self.qkv_bias,
            qk_normalization=self.qk_normalization, norm_type=self.norm_type)


def param_free_layer_norm(x, eps: float = 0.0):
    """(x - mean) / sqrt(var + eps) over the last axis in fp32, in x's dtype."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    return ((xf - mu) / torch.sqrt(var + eps)).to(x.dtype)


def _proj(in_dim: int, hidden: int, out: int, **kw) -> nn.Sequential:
    """Linear, exact GELU, linear (the reference's ``{0, 2}`` keys)."""
    return nn.Sequential(L.Linear(in_dim, hidden, **kw), nn.GELU(), L.Linear(hidden, out, **kw))


class UniFlowVision(nn.Module):
    """The UniFlow tokenizer; ``device`` defaults to CUDA and raises where
    there is none ("meta" builds the shapes only)."""

    def __init__(self, cfg: UniFlowConfig = UniFlowConfig(), dtype=torch.bfloat16,
                 device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.dtype = dtype
        kw = dict(dtype=dtype, param_dtype=torch.float32)
        vh, p = cfg.vit_hidden_size, cfg.patch_size
        grid = cfg.image_size // p
        self._rope_cache: dict = {}
        with dev:
            vit, shallow = cfg.vit(), cfg.vit(num_layers=4)
            self.embeddings = vit_lib.ViTEmbeddings(vit, **kw)
            self.encoder = vit_lib.ViTEncoder(vit, **kw)
            self.shallow_embeddings = vit_lib.ViTEmbeddings(shallow, **kw)
            self.shallow_encoder = vit_lib.ViTEncoder(shallow, **kw)
            self.mlp1 = nn.Sequential(L.LayerNorm(4 * vh, eps=1e-5, dtype=dtype),
                                      L.Linear(4 * vh, cfg.llm_hidden_size, **kw), nn.GELU(),
                                      L.Linear(cfg.llm_hidden_size, cfg.llm_hidden_size, **kw))
            self.shared_latent_proj = C.LatentProjector(vh, 256, 3, **kw)
            if cfg.enable_pixel_branch and cfg.decoder_type == "dcae":
                from deco_tpu_torch.models.dcae import DCAEDecoder

                self.gen_latent_proj = _proj(256, 4 * vh, cfg.latent_ch, **kw)
                self.dcae_decoder = DCAEDecoder(
                    latent_channels=cfg.latent_ch, block_out_channels=cfg.dcae_block_out_channels,
                    layers_per_block=cfg.dcae_layers_per_block,
                    attention_stages=cfg.dcae_attention_stages, head=False, dtype=dtype)
                self.flow_head = FlowDecoder(3, cfg.dcae_block_out_channels[0],
                                             cfg.dcae_flow_width, cfg.dcae_flow_depth,
                                             cfg.num_sampling_steps, patch_size=1, **kw)
            elif cfg.enable_pixel_branch:
                self.gen_latent_proj = _proj(64, 4 * vh, vh, **kw)  # 256 channels / 4 after x2
                self.global_block_pos_embed = nn.Parameter(
                    torch.from_numpy(C.get_2d_sincos_pos_embed(vh, grid))[None])
                self.global_blocks = nn.ModuleList(
                    C.PlainDiTBlock(vh, 16, 4.0, **kw) for _ in range(cfg.global_blocks_depth))
                self.flow_head = FlowDecoder(3 * p * p, vh, vh, cfg.num_decoder_layers,
                                             cfg.num_sampling_steps, patch_size=p, **kw)
            if cfg.enable_semantic_branch:
                self.sem_latent_proj = _proj(256, 4 * vh, 2 * vh, **kw)
                self.sem_global_block_pos_embed = nn.Parameter(
                    torch.from_numpy(C.get_2d_sincos_pos_embed(2 * vh, grid // 2))[None])
                self.sem_global_blocks = nn.ModuleList(
                    C.PlainDiTBlock(2 * vh, 32, 4.0, is_causal=True, **kw)
                    for _ in range(cfg.global_blocks_depth))
                self.sem_flow_head = FlowDecoder(4 * vh, 2 * vh, 2048, 4, cfg.num_sampling_steps,
                                                 patch_size=1, **kw)
            self.register_buffer("mean", torch.from_numpy(IMAGENET_MEAN), persistent=False)
            self.register_buffer("std", torch.from_numpy(IMAGENET_STD), persistent=False)
        self.to(dev)  # tensors made from numpy start on the CPU

    # ---- pieces ----

    def _rope(self, head_dim: int, grid: int, device):
        key = (head_dim, grid, device)
        if key not in self._rope_cache:
            self._rope_cache[key] = tuple(torch.from_numpy(t).to(device) for t in L.precompute_rope_2d(
                head_dim, grid, grid, scale=1.0, extrapolate=True))
        return self._rope_cache[key]

    def forward_encoder(self, pixel_values, normalize_type: str = "siglip"):
        """Images (B, H, W, 3) in [-1, 1] -> (the x0.5-shuffled ViT tokens,
        ``mlp1`` of them, the layer-normed latent)."""
        x = pixel_values
        if normalize_type == "siglip":
            x = (x * 0.5 + 0.5 - self.mean) / self.std
        shallow = self.shallow_encoder(self.shallow_embeddings(x))[0][:, 1:]
        hidden = self.encoder(self.embeddings(x))[0][:, 1:]
        latent = param_free_layer_norm(self.shared_latent_proj(hidden, shallow), eps=1e-5)
        sem_down = C.resample_tokens(hidden, 0.5)
        return sem_down, self.mlp1(sem_down), latent

    def _trunk(self, cond, pos_embed, blocks, heads: int):
        grid = int(round(np.sqrt(cond.shape[1])))
        cond = cond + vit_lib.interp_pos_embed(pos_embed, grid, grid).to(cond.dtype)
        rope = self._rope(cond.shape[-1] // heads, grid, cond.device)
        for block in blocks:
            cond = block(cond, rope)
        return cond

    def run_pixel_trunk(self, latent, out_hw=None):
        """The pixel flow head's condition tokens from the latent."""
        if self.cfg.decoder_type == "dcae":
            cond = param_free_layer_norm(self.gen_latent_proj(latent), eps=1e-5)
            b, n, c = cond.shape
            grid = int(round(np.sqrt(n)))
            feats = self.dcae_decoder(cond.reshape(b, grid, grid, c))
            from deco_tpu_torch.models.vae_models import resize_bilinear

            h, w = out_hw
            feats = resize_bilinear(feats.float(), h, w).to(feats.dtype)
            return feats.reshape(b, h * w, feats.shape[-1])
        cond = self.gen_latent_proj(C.resample_tokens(latent, 2.0))
        return self._trunk(cond, self.global_block_pos_embed, self.global_blocks, 16)

    def run_semantic_trunk(self, latent):
        cond = self.sem_latent_proj(latent)
        return self._trunk(cond, self.sem_global_block_pos_embed, self.sem_global_blocks, 32)

    # ---- training ----

    def forward_loss(self, pixel_values, draws: Optional[dict] = None, generator=None,
                     teacher_feat: Optional[dict] = None,
                     lpips_fn: Optional[Callable] = None) -> dict:
        """The loss terms and their sum ``loss`` (0-d fp32 tensors). ``draws``
        holds each flow head's draws under ``sem`` and ``pix``; without
        them ``generator`` draws."""
        cfg = self.cfg
        draws = draws or {}
        sem_down, sem_after_mlp, latent = self.forward_encoder(pixel_values)
        zero = torch.zeros((), device=pixel_values.device)
        losses, total = {}, zero
        if cfg.enable_semantic_branch:
            if teacher_feat is not None:
                target = param_free_layer_norm(teacher_feat["vit_embeds"])
            else:
                target = param_free_layer_norm(sem_down)
            cond = self.run_semantic_trunk(latent)
            sem_out = self.sem_flow_head.forward_train(target.float(), cond, draws.get("sem"),
                                                       generator)
            pred_after_mlp = self.mlp1(sem_out["pred"].to(self.dtype))
            if teacher_feat is not None:
                distill = (pred_after_mlp.float() - teacher_feat["vit_embeds_mlp"].float()
                           ).square().mean()
                vit_distill = (sem_down.float() - teacher_feat["vit_embeds"].float()
                               ).square().mean()
            else:
                distill = (pred_after_mlp.float() - sem_after_mlp.float()).square().mean()
                vit_distill = zero
            losses.update(distill_loss=distill, vit_distill_loss=vit_distill,
                          sem_mse_loss=sem_out["mse_loss"])
            total = total + distill + sem_out["mse_loss"] + vit_distill
        if cfg.enable_pixel_branch:
            pix_patch = 1 if cfg.decoder_type == "dcae" else cfg.patch_size
            cond = self.run_pixel_trunk(latent, pixel_values.shape[1:3])
            target = C.p2l_transform(pixel_values.float(), pix_patch)
            pix_out = self.flow_head.forward_train(target, cond, draws.get("pix"), generator)
            lpips = zero
            if lpips_fn is not None:
                pred_img = C.l2p_transform(pix_out["pred"], pix_patch).clamp(-1, 1) * 0.5 + 0.5
                lpips = lpips_fn(pred_img, pixel_values.clamp(-1, 1) * 0.5 + 0.5)
            losses.update(flow_loss=pix_out["mse_loss"], lpips_loss=lpips)
            total = total + pix_out["mse_loss"] + lpips
        losses["loss"] = total
        return losses

    # ---- inference ----

    @torch.no_grad()
    def forward(self, pixel_values, mode: str = "pixel", noise=None, generator=None,
                normalize_type: str = "siglip"):
        """Reconstruct: ``pixel`` gives images (B, H, W, 3), ``semantic`` the
        ViT tokens (B, N / 4, 4 vh); ``noise`` is the flow head's starting
        draw, else ``generator`` draws it."""
        if mode not in ("pixel", "semantic"):
            raise ValueError(f"mode {mode!r}: expected 'pixel' or 'semantic'")
        _, _, latent = self.forward_encoder(pixel_values, normalize_type)
        if mode == "pixel":
            cond = self.run_pixel_trunk(latent, pixel_values.shape[1:3])
            return self.flow_head.sample(cond, noise, generator)
        cond = self.run_semantic_trunk(latent)
        return self.sem_flow_head.sample(cond, noise, generator, as_image=False)

    @torch.no_grad()
    def init_like_jax_(self, seed: int) -> "UniFlowVision":
        """Draw the parameters from the JAX initializers' distributions: both
        ViTs as :func:`vit.init_like_jax_`, xavier-uniform projector and
        flow-MLP kernels, zero modulations and final linears, normal(0.02)
        timestep MLPs, the sincos position embeddings, zero ``mask_token``,
        lecun-normal (truncated) other kernels, zero biases, unit norm
        scales. The values come from CPU generators seeded with ``seed``;
        they are not the JAX package's."""
        towers = ("embeddings", "encoder", "shallow_embeddings", "shallow_encoder")
        for i, name in enumerate(towers):
            vit_lib.init_like_jax_(getattr(self, name), seed + i)
        gen = torch.Generator().manual_seed(seed + len(towers))
        norms = {m for m in self.modules() if isinstance(m, (L.RMSNorm, L.LayerNorm))}
        xavier = ("input_proj", "cond_proj", "post_shuffle_proj", "cond_embed", ".mlp.0",
                  ".mlp.2")
        zeros = ("adaLN_modulation.1", "final_layer.linear")
        for module_name, module in self.named_modules():
            if module_name.split(".")[0] in towers or module_name.startswith("dcae_decoder"):
                continue
            for pname, param in module.named_parameters(recurse=False):
                name = f"{module_name}.{pname}" if module_name else pname
                r = torch.empty(param.shape, dtype=torch.float32)
                owner = name.rsplit(".", 1)[0]
                if module in norms:
                    r.fill_(1.0 if pname == "weight" else 0.0)
                elif pname == "bias" or pname == "mask_token" or owner.endswith(zeros):
                    r.zero_()
                elif pname.endswith("pos_embed"):
                    r.copy_(param.detach().float().cpu())  # built as the sincos table
                elif ".time_embed.mlp." in name:
                    r.normal_(0.0, 0.02, generator=gen)
                elif owner.endswith(xavier):
                    fan_out, fan_in = param.shape
                    bound = (6.0 / (fan_in + fan_out)) ** 0.5
                    r.uniform_(-bound, bound, generator=gen)
                else:  # flax lecun_normal: truncated at 2 std, rescaled to unit variance
                    std = (1.0 / param.shape[1]) ** 0.5 / 0.87962566103423978
                    nn.init.trunc_normal_(r, 0.0, std, -2 * std, 2 * std, generator=gen)
                param.copy_(r)
        return self
