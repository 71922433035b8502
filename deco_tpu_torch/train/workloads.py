"""The VAE-GAN and DC-AE-eval workloads, driven by a run config
(``deco_tpu/train/workloads.py`` ``VAEGANRun``, ``run_vae_gan``,
``run_dcae_eval``); ``deco_tpu_torch.cli`` routes their configs here.

Two schemas, as in JAX:

- the reference schema (``configs/vae_*.yaml``): ``model.vae_model`` and
  ``model.loss_module`` class-path nodes, the default
  ``NLayerDiscriminator``, ``model.optimizer`` and
  ``model.discriminator_optimizer`` AdamW nodes, ``model.ema_tracker``,
  ``model.freeze_encoder`` and ``model.eval_original_model``;
- the flat schema (``configs/vae_training_flat.yaml``): ``model.vit``,
  ``discriminator``, ``loss``, ``optimizer`` and ``data.train_root``.

fit: the train dataset through the loader, the two-optimizer step
(``train/vae_gan_step.py``) with a generator seeded from (seed, step) for
the posterior's noise, ``metrics.jsonl`` (``ScalarLogger``, with the W&B
gate), step checkpoints, a resume from ``--ckpt_path`` or the workdir's
latest, a save on exception and at the end, and SIGTERM as a stop request.
validate: the eval dataset, each batch padded to a 2 x patch canvas with -1
and the reconstruction cropped back (the reference protocol), PSNR, SSIM
and FID (``ComputeMetricsHook``), original|reconstruction panels
(``ImageLogger``), the ``SaveImagesHook`` npz, and ``validate_metrics.json``.
A run that does not restore draws every parameter from ``seed``
(``vae_models.init_like_jax_``). The model keeps fp32 parameters and
computes in bf16 on ``device``.

The checkpoint is one torch file a step (``train/checkpoint.py``'s
``CheckpointManager``): ``state_dict`` with ``vae.``, ``ema_vae.`` and
``disc.`` keys, ``optimizer`` with each parameter's AdamW moments by the
same names, ``lecam`` and ``step``.
"""

from __future__ import annotations

import json
import os
import warnings
from typing import Any, Dict, Optional

import numpy as np
import torch

from deco_tpu_torch._device import resolve_device
from deco_tpu_torch.config import registry
from deco_tpu_torch.data.loader import make_loader
from deco_tpu_torch.models.autoencoders import fp_to_uint8
from deco_tpu_torch.train.checkpoint import MOMENTS, CheckpointManager


class _TrainerSection:
    """The reference Lightning ``trainer:`` block as the run loops read it."""

    def __init__(self, config: Dict[str, Any]):
        t = config.get("trainer", {}) or {}
        self.max_steps = t.get("max_steps")
        self.grad_clip = t.get("gradient_clip_val", 1.0)
        self.log_every = t.get("log_every_n_steps", 10)
        self.default_root_dir = t.get("default_root_dir", "./workdirs")
        cbs = {}
        for cb in t.get("callbacks", []) or []:
            cbs[cb.get("class_path", "").rsplit(".", 1)[-1]] = cb.get("init_args", {}) or {}
        self.ckpt_every = cbs.get("CheckpointHook", {}).get("every_n_train_steps", 10000)
        self.metrics_cfg = cbs.get("ComputeMetricsHook")
        self.save_images_cfg = cbs.get("SaveImagesHook")
        lg = t.get("logger") or {}
        self.wandb_project = None
        if "WandbLogger" in str(lg.get("class_path", "")):
            args = lg.get("init_args", {}) or {}
            self.wandb_project = args.get("project", args.get("name", "deco"))


def _opt_args(node, default_lr: float):
    """An AdamW class-path node -> (lr, weight_decay, betas), numbers as floats."""
    args = (node or {}).get("init_args", {}) or {}
    return (float(args.get("lr", default_lr)), float(args.get("weight_decay", 0.0)),
            tuple(float(b) for b in args.get("betas", (0.9, 0.95))))


def _make_dataset(data_cfg: Dict[str, Any], key: str, resolution: int):
    """Reference schema: ``data.<key>`` through the registry; flat schema:
    ``train_root``, an image folder."""
    node = data_cfg.get(key)
    if isinstance(node, dict) and "class_path" in node:
        return registry.instantiate(node)
    if key == "train_dataset" and "train_root" in data_cfg:
        from deco_tpu_torch.data.imagenet import PixImageNet

        return PixImageNet(data_cfg["train_root"], resolution=resolution)
    return None


def _workdir(config, trainer: _TrainerSection, workdir: Optional[str], default: str) -> str:
    if workdir:
        return workdir
    exp = (config.get("tags") or {}).get("exp")
    return os.path.join(trainer.default_root_dir, str(exp)) if exp else default


class VAEGANRun:
    """The VAE-GAN workload (the reference's ``LightningModelVAE``)."""

    def __init__(self, config: Dict[str, Any], workdir: Optional[str] = None, device="cuda"):
        from deco_tpu_torch.models.gan.discriminator import NLayerDiscriminator
        from deco_tpu_torch.models.gan.vae_loss import VAEGANLoss

        self.config = config
        self.device = resolve_device(device)
        self.trainer = _TrainerSection(config)
        self.seed = int(config.get("seed", 0))
        m = config["model"]
        if "vae_model" in m:  # the reference schema
            node = m["vae_model"]
            self.vae = registry.instantiate({**node, "init_args": {
                **(node.get("init_args") or {}), "device": str(self.device)}})
            loss_node = registry.instantiate(m["loss_module"])
            self.loss_cfg = loss_node.loss_cfg
            self.perceptual_spec = loss_node.perceptual_spec
            disc_kw = {}
            self.freeze_encoder = bool(m.get("freeze_encoder", False))
            self.gen_opt = _opt_args(m.get("optimizer"), 1e-4)
            self.disc_opt = _opt_args(m.get("discriminator_optimizer"), 1e-4)
            self.use_ema = "ema_tracker" in m
            self.ema_decay = float(((m.get("ema_tracker") or {}).get("init_args", {}) or {})
                                   .get("decay", 0.9999))
            self.eval_original_model = bool(m.get("eval_original_model", True))
        else:  # the flat schema
            from deco_tpu_torch.models.uniflow.vit import ViTConfig
            from deco_tpu_torch.models.vae_models import VAEModel

            vit = ViTConfig(**{k: v for k, v in (m.get("vit") or {}).items()
                               if k in ViTConfig.__dataclass_fields__})
            vae_kw = {k: tuple(m[k]) for k in ("decoder_channels", "decoder_layers",
                                                "decoder_attn") if k in m}
            self.vae = VAEModel(vit=vit, llm_hidden_size=m.get("llm_hidden_size", 1536),
                                latent_channel=m.get("latent_channel", 32),
                                gen_select_layer=m.get("gen_select_layer", 18),
                                stochastic=m.get("stochastic", False), device=self.device,
                                **vae_kw)
            disc_kw = config.get("discriminator", {}) or {}
            loss_keys = ("reconstruction_loss", "reconstruction_weight", "perceptual_weight",
                         "discriminator_weight", "discriminator_factor",
                         "discriminator_iter_start", "lecam_regularization_weight",
                         "distillation_weight", "distillation_loss_type", "kl_weight")
            loss = config.get("loss", {}) or {}
            self.loss_cfg = VAEGANLoss(**{k: v for k, v in loss.items() if k in loss_keys})
            self.perceptual_spec = loss.get("perceptual_model")
            opt = config.get("optimizer", {}) or {}
            self.gen_opt = (float(opt.get("gen_lr", 1e-4)), 0.0, (0.9, 0.95))
            self.disc_opt = (float(opt.get("disc_lr", 1e-4)), 0.0, (0.9, 0.95))
            self.trainer.grad_clip = opt.get("grad_clip", self.trainer.grad_clip)
            self.freeze_encoder = bool(m.get("freeze_encoder", False))
            self.use_ema = False
            self.ema_decay = 0.9999
            self.eval_original_model = True
        with self.device:
            self.disc = NLayerDiscriminator(**disc_kw)
        self._perceptual = None  # built at first use (two frozen towers)
        self.workdir = _workdir(config, self.trainer, workdir, "./workdirs_vae")
        os.makedirs(self.workdir, exist_ok=True)

    # ---- data and state ----

    def _loader(self, key: str, infinite: bool):
        data_cfg = self.config.get("data", {}) or {}
        res = data_cfg.get("resolution", self.vae.vit.image_size)
        dataset = _make_dataset(data_cfg, key, res)
        if dataset is None:
            raise ValueError(f"config has no data.{key}")
        size_key = "train_batch_size" if key == "train_dataset" else "pred_batch_size"
        batch = int(data_cfg.get(size_key, data_cfg.get("batch_size", 4)))
        workers = data_cfg.get("train_num_workers" if infinite else "pred_num_workers", 4)
        return make_loader(dataset, batch, infinite=infinite, shuffle=infinite,
                           num_workers=workers), batch

    def _init_state(self):
        """Parameters drawn from ``seed``, AdamW for both sides with the
        cosine-with-min-lr rate over ``max_steps`` (the reference
        optimizers), the generator EMA, and the tower frozen with
        ``freeze_encoder``."""
        from deco_tpu_torch.models.vae_models import init_like_jax_
        from deco_tpu_torch.train.schedules import cosine_with_min_lr
        from deco_tpu_torch.train.vae_gan_step import VAEGANTrainState

        init_like_jax_(self.vae, self.seed)
        init_like_jax_(self.disc, self.seed + 1)
        total = self.trainer.max_steps or 200000
        return VAEGANTrainState.create(
            self.vae.train(), self.disc.train(), self.gen_opt[1:], self.disc_opt[1:],
            cosine_with_min_lr(self.gen_opt[0], 0, total, 0.0),
            cosine_with_min_lr(self.disc_opt[0], 0, total, 0.0), ema=self.use_ema,
            frozen=("vision_model",) if self.freeze_encoder else ())

    def _payload(self, state) -> dict:
        sd, optimizer = {}, {}
        for side, module, opt in (("vae", state.vae, state.gen_opt),
                                  ("disc", state.disc, state.disc_opt)):
            for n, p in module.named_parameters():
                sd[f"{side}.{n}"] = p.detach().cpu()
                if p in opt.state:
                    optimizer[f"{side}.{n}"] = {k: opt.state[p][k].detach().cpu()
                                                for k in MOMENTS}
        if state.gen_ema is not None:
            for (n, _), e in zip(state.vae.named_parameters(), state.gen_ema):
                sd[f"ema_vae.{n}"] = e.detach().cpu()
        return {"state_dict": sd, "optimizer": optimizer, "step": int(state.step),
                "lecam": {"ema_real": state.lecam.ema_real.detach().cpu(),
                          "ema_fake": state.lecam.ema_fake.detach().cpu()}}

    def _restore(self, manager: CheckpointManager, state, step: Optional[int] = None):
        from deco_tpu_torch.models.gan.vae_loss import LeCamState

        obj = manager.load(step)
        sd = obj["state_dict"]
        with torch.no_grad():
            for side, module, opt in (("vae", state.vae, state.gen_opt),
                                      ("disc", state.disc, state.disc_opt)):
                named = list(module.named_parameters())
                for n, p in named:
                    p.copy_(sd[f"{side}.{n}"])
                index = {p: i for i, p in enumerate(opt.param_groups[0]["params"])}
                osd = opt.state_dict()
                osd["state"] = {index[p]: dict(obj["optimizer"][f"{side}.{n}"])
                                for n, p in named if f"{side}.{n}" in obj["optimizer"]}
                opt.load_state_dict(osd)
            if state.gen_ema is not None:
                for (n, p), e in zip(state.vae.named_parameters(), state.gen_ema):
                    e.copy_(sd.get(f"ema_vae.{n}", p))
        state.lecam = LeCamState(**{k: v.to(self.device) for k, v in obj["lecam"].items()})
        state.step = int(obj["step"])
        return state

    @property
    def perceptual(self):
        if self._perceptual is None and self.perceptual_spec:
            from deco_tpu_torch.models.perceptual import PerceptualLoss

            self._perceptual = PerceptualLoss(self.perceptual_spec, device=self.device)
        return self._perceptual

    def _to_device(self, array) -> torch.Tensor:
        t = torch.as_tensor(np.asarray(array, np.float32))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    # ---- fit ----

    def fit(self, max_steps: Optional[int] = None, ckpt_path: Optional[str] = None):
        """Train to ``max_steps`` (else the trainer's); returns the state."""
        from deco_tpu_torch.train.hooks import ScalarLogger
        from deco_tpu_torch.train.loop import step_seed
        from deco_tpu_torch.train.vae_gan_step import make_vae_gan_step
        from deco_tpu_torch.utils.preemption import PreemptionGuard

        loader, _ = self._loader("train_dataset", infinite=True)
        state = self._init_state()
        ckpt = CheckpointManager(os.path.join(self.workdir, "checkpoints"),
                                 every_n_steps=self.trainer.ckpt_every)
        if ckpt_path:
            self._restore(CheckpointManager(ckpt_path, 0), state)
        elif ckpt.latest_step() is not None:
            self._restore(ckpt, state)
        step_fn = make_vae_gan_step(self.loss_cfg, perceptual_fn=self.perceptual,
                                    grad_clip=self.trainer.grad_clip, ema_decay=self.ema_decay)
        logger = ScalarLogger(self.workdir, log_every_n_steps=self.trainer.log_every,
                              wandb_project=self.trainer.wandb_project, run_config=self.config)
        limit = max_steps if max_steps is not None else (self.trainer.max_steps or 200000)

        def checkpoint(force: bool = False):
            if force or (ckpt.every_n_steps > 0 and state.step % ckpt.every_n_steps == 0):
                ckpt.save(self._payload(state), state.step)

        try:
            with PreemptionGuard() as preempt:
                for bx, _, _ in loader:
                    if state.step >= limit or preempt.requested:
                        break
                    gen = torch.Generator(device=self.device).manual_seed(
                        step_seed(self.seed, state.step))
                    step = state.step
                    metrics = step_fn(state, self._to_device(bx), generator=gen)
                    logger.log(step, metrics)
                    checkpoint()
        except BaseException:
            checkpoint(force=True)
            raise
        finally:
            logger.close()
        checkpoint(force=True)
        return state

    # ---- validate ----

    @torch.no_grad()
    def validate(self, state=None, ckpt_path: Optional[str] = None,
                 max_batches: Optional[int] = None) -> dict:
        """Reconstruction scores of the eval dataset; returns them."""
        from deco_tpu_torch.train.hooks import ComputeMetricsHook, ImageLogger, SaveImagesHook

        loader, _ = self._loader("eval_dataset", infinite=False)
        if state is None:
            state = self._init_state()
            path = ckpt_path or os.path.join(self.workdir, "checkpoints")
            try:
                self._restore(CheckpointManager(path, 0), state)
            except FileNotFoundError:
                warnings.warn(f"validate with randomly initialized params (no checkpoint under "
                              f"{path})")
        vae = state.vae.eval()
        kept = None
        if not self.eval_original_model and state.gen_ema is not None:
            kept = [p.clone() for p in vae.parameters()]
            torch._foreach_copy_(list(vae.parameters()), state.gen_ema)
        metrics_hook = ComputeMetricsHook(**(self.trainer.metrics_cfg or {}), device=self.device)
        imlog = ImageLogger(self.workdir)
        save_hook = None
        if self.trainer.save_images_cfg is not None:
            save_hook = SaveImagesHook(**self.trainer.save_images_cfg)
            save_hook.on_predict_start(self.workdir, state.step)
        # the reference protocol: centre-pad to a 2 x patch canvas with -1,
        # reconstruct, centre-crop the reconstruction back to the input
        mult = 2 * self.vae.vit.patch_size
        try:
            for bi, (bx, _, bmeta) in enumerate(loader):
                if max_batches is not None and bi >= max_batches:
                    break
                x = self._to_device(bx)
                h, w = x.shape[1], x.shape[2]
                ph, pw = (-h) % mult, (-w) % mult
                xp = torch.nn.functional.pad(
                    x, (0, 0, pw // 2, pw - pw // 2, ph // 2, ph - ph // 2), value=-1.0)
                recon = vae(xp)[0]
                ct, cl = (recon.shape[1] - h) // 2, (recon.shape[2] - w) // 2
                recon = recon[:, ct:ct + h, cl:cl + w]
                ru8, ou8 = fp_to_uint8(recon).cpu().numpy(), fp_to_uint8(x).cpu().numpy()
                metrics_hook.on_batch_end(ru8, ou8)
                imlog.log_side_by_side(state.step, ou8, ru8)
                if save_hook is not None:
                    save_hook.on_predict_batch_end(ru8, bmeta)
        finally:
            if kept is not None:
                torch._foreach_copy_(list(vae.parameters()), kept)
        scores = metrics_hook.on_epoch_end()
        if save_hook is not None:
            save_hook.on_predict_end()
        if scores:
            with open(os.path.join(self.workdir, "validate_metrics.json"), "w") as f:
                json.dump({k: float(v) for k, v in scores.items()}, f)
        return scores


def run_vae_gan(config: Dict[str, Any], max_steps: Optional[int] = None,
                workdir: Optional[str] = None, ckpt_path: Optional[str] = None,
                subcommand: str = "fit", max_batches: Optional[int] = None, device="cuda"):
    run = VAEGANRun(config, workdir=workdir, device=device)
    if subcommand == "fit":
        return run.fit(max_steps=max_steps, ckpt_path=ckpt_path)
    return run.validate(ckpt_path=ckpt_path, max_batches=max_batches)


def run_dcae_eval(config: Dict[str, Any], max_batches: Optional[int] = None, device="cuda"):
    """``configs_flow/dcae_decoder_eval.yaml`` -> :func:`deco_tpu_torch.eval_dcae.evaluate`:
    the eval dataset's ``root`` (an image folder), ``data.resolution``
    (default 224), ``pred_batch_size``, ``llm_hidden_size``, 8 batches
    unless ``max_batches``, and ``decoder_checkpoint_path``."""
    from deco_tpu_torch.eval_dcae import evaluate

    m = config.get("model", {}) or {}
    data = config.get("data", {}) or {}
    root = ((data.get("eval_dataset", {}) or {}).get("init_args", {}) or {}).get(
        "root", data.get("eval_root", "."))
    return evaluate(image_root=root, resolution=data.get("resolution", 224),
                    batch_size=data.get("pred_batch_size", 4),
                    llm_hidden_size=m.get("llm_hidden_size", 3200),
                    max_batches=max_batches if max_batches is not None else 8,
                    ckpt_path=m.get("decoder_checkpoint_path"), device=device)
