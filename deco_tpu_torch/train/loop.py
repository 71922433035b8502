"""Experiment orchestration: config -> model, trainer, sampler, data ->
fit / predict (``deco_tpu/train/loop.py`` ``Experiment``).

- The workdir is ``<trainer.default_root_dir>/<tags.exp>``; a workdir that
  is not empty is refused unless the run resumes. Each run writes the
  config it ran as ``config.yaml``.
- fit: the train dataset through the loader (an image folder, the t2i
  image-caption folder, or a stream), the conditioner on each batch's labels
  or prompts, the metadata the trainer names (``metadata_keys``: REPA's
  ``raw_image``), the train step (loss, gradients, clip, AdamW, EMA) with a
  generator seeded from (seed, step), ``metrics.jsonl``, step checkpoints, a
  resume that continues a folder's data order (a stream starts over, as in
  the JAX loop), a save on exception and at the end, and SIGTERM as a stop
  request.
- predict: the seeded-noise dataset (class labels, or the GenEval/DPG
  prompts of the t2i configs, which the text conditioner encodes on the
  host and whose ``valid_length_y`` rides in the metadata), the config's
  sampler on the EMA weights, ``vae.decode``, ``fp_to_uint8``, each
  sample's own ``save_fn`` (the FID protocol's ``<class>_<seed>.png``,
  DPG's ``<prompt>_<seed>.png``, GenEval's ``<idx>/samples/<seed>.png``)
  and the ADM ``output.npz``, with the next batch launched before the last
  is read back;
  with a ``ComputeMetricsHook`` callback, batches whose metadata carry
  ``raw_image`` are scored against it (PSNR, SSIM, FID) into
  ``predict_metrics.json``.
- reconstruction (the ReCo configs, which have no ``conditioner`` node:
  :class:`~deco_tpu_torch.models.conditioners.ImageConditioner`): fit
  conditions on the batch's images, repeated with the batch by
  ``diffusion_batch_mul``; validate and predict take the loader's images as
  the condition, start the sampler from fresh noise drawn from a generator
  seeded by (seed, batch), write each original beside its reconstruction
  (``ImageLogger.log_side_by_side``) and score the reconstructions against
  the originals.

An int8 model (``quantize="int8"`` or ``DECO_QUANT=int8``) predicts with
its weight cache built from the weights it samples with (after the
checkpoint and the EMA swap); fit refuses it (``TrainState.create``).

A REPA or JiT trainer sets the model's ``align_layer`` (its feature tap), and
its projection (``proj_module``, drawn from ``seed``) trains beside the
model; its ``encoder`` (the DINOv2 node) is built on ``device``. The DeCo
trainer, which never runs its encoder, keeps the node unbuilt.

The model keeps fp32 parameters and computes in the config's ``dtype``
(bf16 unless overridden) on ``device``; a run that does not restore draws
them from the JAX initializers' distributions (``init_like_jax_``, or the
model's own method of that name, ``ReCoModel``'s), seeded by ``seed``.
A ``WandbLogger`` node names the W&B project (its ``project``, else its
``name``), which logs only where ``wandb`` imports
(``hooks._maybe_wandb``). The keys the JAX loop does not read are not read
here either: ``model.distill``, ``model.pretrain_model_path``,
``model.eval_original_model``, ``data.train_prefetch_factor`` and
``trainer.plugins``. Neither loop reads a tensor back
from the card on every step: fit reads the metrics on log steps only, and
waits on a CUDA event ``_TRAIN_RUNAHEAD`` steps back so the host runs ahead
of the card by a bounded number of steps.

Several processes (``torchrun``, one per GPU; ``parallel/distributed.py``):
the (data, model) mesh comes from ``mesh_model_axis`` (the data axis takes
the rest of the world), as in JAX, and is the current mesh inside fit and
predict, where the models' ``trunk_parallel`` executors read it. The
global batch is ``train_batch_size x data axis x accumulate_grad_batches``
(``pred_batch_size x data axis`` for predict), and each data rank loads and
decodes only its rows of it (``data/loader.py``). fit wraps the model in
DDP (a model axis of 1) or shards it with FSDP2 (``parallel.mesh.shard_params``,
a model axis above 1), draws the step's noise and t for the global batch
and keeps its rows, and logs the global mean; rank 0 writes the logs and
each checkpoint, whole, and the on-exception save is skipped (the other
ranks may sit in a collective). predict runs each data rank's rows, and
the data ranks of model index 0 write the images: each file is the
world-1 predict's, by name and by byte (the ``output.npz`` merged in the
global order, the sample panels from the global batch), and the metrics
are gathered over the ranks. So a fit or a predict on W ranks computes
what one process over the same global batch computes.
"""

from __future__ import annotations

import json
import os
from collections import deque
from typing import Any, Dict, Optional

import numpy as np
import torch

from deco_tpu_torch._device import resolve_device
from deco_tpu_torch.config import _yaml, registry
from deco_tpu_torch.data.loader import make_loader
from deco_tpu_torch.diffusion.training import JiTTrainer, REPATrainer
from deco_tpu_torch.models.autoencoders import fp_to_uint8
from deco_tpu_torch.models.conditioners import ImageConditioner
from deco_tpu_torch.models.dit_c2i_deco import init_like_jax_
from deco_tpu_torch.ops import quant
from deco_tpu_torch.parallel import distributed
from deco_tpu_torch.parallel import mesh as mesh_lib
from deco_tpu_torch.train.checkpoint import CheckpointManager
from deco_tpu_torch.train.hooks import (
    ComputeMetricsHook,
    ImageLogger,
    SaveImagesHook,
    ScalarLogger,
)
from deco_tpu_torch.train.train_step import make_train_step
from deco_tpu_torch.utils.pipeline import pipelined_map
from deco_tpu_torch.utils.preemption import PreemptionGuard


def step_seed(seed: int, step: int) -> int:
    """The seed of step ``step``'s generator: a pure function of (seed, step),
    so a resumed run draws what an uninterrupted one would."""
    return int(np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0])


class Experiment:
    # steps the host may launch ahead of the card in fit()
    _TRAIN_RUNAHEAD = 2

    def __init__(self, config: Dict[str, Any], workdir: Optional[str] = None,
                 resume: bool = False, device="cuda"):
        self.config = config
        self.device = resolve_device(device)
        if "mesh" in config:
            raise ValueError("the diffusion loop takes its mesh from `mesh_model_axis`; the "
                             "`mesh:` node is the UniFlow and VAE-GAN workloads'")
        self.mesh = mesh_lib.make_mesh(model=config.get("mesh_model_axis", 1))
        self.data_rank = mesh_lib.axis_index(self.mesh, mesh_lib.DATA_AXIS)
        self.data_size = mesh_lib.axis_size(self.mesh, mesh_lib.DATA_AXIS)
        self.writer = distributed.rank() == 0
        model_cfg = config["model"]
        self.vae = registry.instantiate(model_cfg["vae"])
        self.model = self._build_model(model_cfg["denoiser"])
        # the reconstruction configs have no conditioner: the condition is the image
        self.conditioner = (registry.instantiate(model_cfg["conditioner"])
                            if "conditioner" in model_cfg else ImageConditioner())
        self._cond_on_images = getattr(self.conditioner, "wants_images", False)
        self.trainer = registry.instantiate(self._on_device(model_cfg["diffusion_trainer"]))
        if isinstance(self.trainer, (REPATrainer, JiTTrainer)):
            # the REPA tap: the trainer's align layer is the model's
            self.model.align_layer = self.trainer.align_layer
        if self.trainer.proj_module is not None:
            self.trainer.proj_module.to(self.device)
        self.sampler = registry.instantiate(model_cfg["diffusion_sampler"])
        self.ema_cfg = registry.instantiate(
            model_cfg.get("ema_tracker", {"class_path": "src.callbacks.simple_ema.SimpleEMA"}))
        self.opt_cfg = registry.instantiate(
            model_cfg.get("optimizer", {"class_path": "torch.optim.AdamW"}))
        self.seed = int(config.get("seed", 0))
        trainer_cfg = config.get("trainer", {})
        self.max_steps = trainer_cfg.get("max_steps", 100)
        self.ckpt_every = 10000
        self.log_every = trainer_cfg.get("log_every_n_steps", 50)
        self.grad_clip = trainer_cfg.get("gradient_clip_val")
        self.accumulate_grad_batches = trainer_cfg.get("accumulate_grad_batches", 1)
        self.save_images_cfg = {"save_dir": "val"}
        self.metrics_hook_cfg = None
        for cb in trainer_cfg.get("callbacks", []):
            cp, args = cb.get("class_path", ""), cb.get("init_args") or {}
            if cp.endswith("CheckpointHook"):
                self.ckpt_every = args.get("every_n_train_steps", self.ckpt_every)
            elif cp.endswith("SaveImagesHook"):
                self.save_images_cfg = dict(args)
            elif cp.endswith("ComputeMetricsHook"):
                self.metrics_hook_cfg = dict(args)
            else:
                raise ValueError(f"callback {cp!r}: the port knows CheckpointHook, "
                                 "SaveImagesHook and ComputeMetricsHook")
        logger = trainer_cfg.get("logger") or {}
        self.wandb_project = None
        if "WandbLogger" in str(logger.get("class_path", "")):
            args = logger.get("init_args") or {}
            self.wandb_project = args.get("project", args.get("name", "deco"))
        # the reference LightningModel's default; the shipped configs set 1 or 4
        self.diffusion_batch_mul = model_cfg.get("diffusion_batch_mul", 4)

        exp_name = config.get("tags", {}).get("exp", "exp")
        root = trainer_cfg.get("default_root_dir", "./workdirs")
        self.workdir = workdir or os.path.join(root, exp_name)
        if os.path.isdir(self.workdir) and os.listdir(self.workdir) and not resume:
            raise FileExistsError(f"workdir {self.workdir} is not empty; pass resume=True or "
                                  "--ckpt_path to continue")
        distributed.barrier()  # every rank has looked before rank 0 writes
        os.makedirs(self.workdir, exist_ok=True)
        if self.writer:
            with open(os.path.join(self.workdir, "config.yaml"), "w") as f:
                f.write(_yaml.dump(self.config))

    def _on_device(self, trainer_node: dict) -> dict:
        """The trainer node with its ``encoder`` node (REPA's frozen tower)
        set to this experiment's device, where it is built (at once, or at
        its first call for a trainer that defers it)."""
        args = trainer_node.get("init_args") or {}
        encoder = args.get("encoder")
        if not (isinstance(encoder, dict) and "class_path" in encoder):
            return trainer_node
        encoder = {**encoder, "init_args": {**(encoder.get("init_args") or {}),
                                            "device": str(self.device)}}
        return {**trainer_node, "init_args": {**args, "encoder": encoder}}

    def _build_model(self, node: dict):
        """The denoiser with fp32 parameters on this experiment's device."""
        args = dict(node.get("init_args") or {}, device=str(self.device), param_dtype="float32")
        return registry.instantiate({**node, "init_args": args})

    def _to_device(self, array) -> torch.Tensor:
        t = torch.as_tensor(array)
        if self.device.type == "cuda":
            # a pinned source lets the copy run without waiting for the card
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _condition(self, bx, by, bmeta):
        cond, uncond = self.conditioner(bx if self._cond_on_images else by, bmeta)
        return self._to_device(cond), self._to_device(uncond)

    def _parallel(self):
        """What the train step runs on a mesh: the model sharded by FSDP2 (a
        model axis above 1) or under DDP; the model itself without a mesh."""
        if self.mesh is None:
            return None
        if mesh_lib.axis_size(self.mesh, mesh_lib.MODEL_AXIS) > 1:
            tp = getattr(self.model, "trunk_parallel", "none") == "tp"
            return mesh_lib.shard_params(self.model, self.mesh,
                                         whole=[self.model.blocks] if tp else [])
        from torch.nn.parallel import DistributedDataParallel

        ids = [torch.cuda.current_device()] if self.device.type == "cuda" else None
        # DDP walks the autograd graph each backward only for a model whose
        # loss leaves parameters out (ReCo's ``mlp1``)
        return DistributedDataParallel(
            self.model, device_ids=ids, broadcast_buffers=False,
            find_unused_parameters=getattr(self.model, "unused_in_fit", False))

    def _init_like_jax(self):
        init = getattr(self.model, "init_like_jax_", None)
        if init is not None:
            init(self.seed)
        else:
            init_like_jax_(self.model, self.seed)

    # ---- fit ----

    def fit(self, ckpt_path: Optional[str] = None, max_steps: Optional[int] = None):
        with mesh_lib.use_mesh(self.mesh):
            return self._fit(ckpt_path, max_steps)

    def _fit(self, ckpt_path: Optional[str], max_steps: Optional[int]):
        data_cfg = self.config["data"]
        dataset = registry.instantiate(data_cfg["train_dataset"])
        batch_size = data_cfg.get("train_batch_size", 32) * self.accumulate_grad_batches
        loader = make_loader(dataset, batch_size,
                             num_workers=data_cfg.get("train_num_workers", 4), infinite=True,
                             process_index=self.data_rank, process_count=self.data_size,
                             microbatches=self.accumulate_grad_batches)
        self._init_like_jax()  # before the EMA copies the parameters
        proj = self.trainer.proj_module
        if proj is not None:
            proj.reset_parameters(self.seed)
        net = self._parallel()  # before the optimizer sees the (sharded) parameters
        state = self.opt_cfg.create_state(self.model.train(), trainer_module=proj)
        state.net = net
        ckpt = CheckpointManager(os.path.join(self.workdir, "checkpoints"),
                                 every_n_steps=self.ckpt_every)
        if ckpt_path:
            CheckpointManager(ckpt_path, 0).restore(state)
        elif ckpt.latest_step() is not None:
            ckpt.restore(state)
        if state.step and hasattr(loader, "set_position"):
            # one loader batch per step, and the shuffle is a pure function of
            # (seed, epoch): the resumed run takes the batches the interrupted
            # run would have taken. A stream (IterableLoader) starts over.
            loader.set_position(state.step)
        step_fn = make_train_step(
            self.trainer, ema_decay=self.ema_cfg.decay, ema_every=self.ema_cfg.every_n_steps,
            diffusion_batch_mul=self.diffusion_batch_mul, grad_clip=self.grad_clip,
            accumulate_grad_batches=self.accumulate_grad_batches, mesh=self.mesh)
        logger = ScalarLogger(self.workdir, log_every_n_steps=self.log_every,
                              wandb_project=self.wandb_project, run_config=self.config,
                              writer=self.writer)
        limit = max_steps if max_steps is not None else self.max_steps
        inflight: deque = deque()
        try:
            with PreemptionGuard() as preempt:
                for bx, by, bmeta in loader:
                    if state.step >= limit or preempt.requested:
                        break
                    cond, uncond = self._condition(bx, by, bmeta)
                    batch = dict(x=self._to_device(bx), condition=cond, uncondition=uncond)
                    meta = {k: self._to_device(np.asarray(bmeta[k], np.float32))
                            for k in self.trainer.metadata_keys if k in bmeta}
                    if meta:
                        batch["metadata"] = meta
                    gen = torch.Generator(device=self.device).manual_seed(
                        step_seed(self.seed, state.step))
                    step = state.step
                    metrics = step_fn(state, batch, gen)
                    logger.log(step, metrics)
                    ckpt.maybe_save(state)
                    if self.device.type == "cuda":
                        inflight.append(torch.cuda.Event())
                        inflight[-1].record()
                        if len(inflight) > self._TRAIN_RUNAHEAD:
                            inflight.popleft().synchronize()
        except BaseException:
            if distributed.world_size() == 1:  # the others may sit in a collective
                ckpt.maybe_save(state, force=True)  # crash and preemption recovery
            raise
        finally:
            logger.close()
        ckpt.maybe_save(state, force=True)
        return state

    # ---- predict ----

    def predict(self, state=None, ckpt_path: Optional[str] = None, use_ema: bool = True,
                max_batches: Optional[int] = None, dataset_key: str = "pred_dataset"):
        """Sample the ``dataset_key`` dataset with the EMA weights (of
        ``state``, of the checkpoint under ``ckpt_path``, or the model's own);
        returns the ``output.npz`` path (or None without ``save_compressed``,
        and on the ranks that do not write it)."""
        with mesh_lib.use_mesh(self.mesh), torch.no_grad():
            return self._predict(state, ckpt_path, use_ema, max_batches, dataset_key)

    def _predict(self, state, ckpt_path, use_ema, max_batches, dataset_key):
        data_cfg = self.config["data"]
        dataset = registry.instantiate(data_cfg[dataset_key])
        local = data_cfg.get("pred_batch_size", 32)
        loader = make_loader(dataset, local, shuffle=False,
                             drop_last=True, num_workers=data_cfg.get("pred_num_workers", 1),
                             process_index=self.data_rank, process_count=self.data_size)
        global_batch = local * self.data_size
        # the data ranks of model index 0 write; a model group's ranks sample alike
        writes = mesh_lib.axis_index(self.mesh, mesh_lib.MODEL_AXIS) == 0
        step, kept = 0, None
        if state is not None:
            step = state.step
            if use_ema and state.ema_params is not None:
                # sample with the EMA in the model's parameters; the trained
                # parameters come back at the end
                kept = [p.clone() for p in self.model.parameters()]
                torch._foreach_copy_(list(self.model.parameters()), state.model_ema())
        elif ckpt_path:
            step = CheckpointManager(ckpt_path, 0).restore_params(self.model, use_ema=use_ema)
        else:
            self._init_like_jax()
        model = self.model.eval()
        if quant.model_quant_active(model):
            quant.refresh_quant_cache(model)  # from the weights it samples with
        hook = SaveImagesHook(**self.save_images_cfg)
        hook.on_predict_start(self.workdir, step, process_index=self.data_rank,
                              process_count=self.data_size, writes=writes)
        imlog = ImageLogger(self.workdir)
        metrics_hook = None
        if self.metrics_hook_cfg is not None:
            metrics_hook = ComputeMetricsHook(**self.metrics_hook_cfg, device=self.device)

        def batches():
            for bi, (bx, by, bmeta) in enumerate(loader):
                if max_batches is not None and bi >= max_batches:
                    return
                cond, uncond = self._condition(bx, by, bmeta)
                x = self._to_device(bx)
                if self._cond_on_images:
                    # reconstruction: the loader's images are the condition,
                    # the sampler starts from fresh noise
                    gen = torch.Generator(device=self.device).manual_seed(
                        step_seed(self.seed, 1000 + bi))
                    noise = mesh_lib.sample(mesh_lib.microbatch_draws(gen, self.mesh, len(x)),
                                            x.shape, self.device)
                    yield bi, bmeta, noise, cond, uncond, x
                else:
                    yield bi, bmeta, x, cond, uncond, None

        def dispatch(b):
            _, _, noise, cond, uncond, x = b
            images = self.vae.decode(self.sampler(model, noise, cond, uncond))
            return fp_to_uint8(images), None if x is None else fp_to_uint8(x)

        def consume(out, b):
            bi, bmeta = b[0], b[1]
            u8, orig = (None if t is None else t.cpu().numpy() for t in out)  # this batch only
            if writes:
                hook.on_predict_batch_end(u8, bmeta,
                                          first_index=bi * global_batch + self.data_rank * local)
            # the panels are the global batch's: gathered while there is room
            if orig is not None and bi * global_batch < imlog.max_images:
                u8_all = mesh_lib.gather_data_rows(self.mesh, u8)
                orig_all = mesh_lib.gather_data_rows(self.mesh, orig)
                if self.writer:
                    imlog.log_side_by_side(step, orig_all, u8_all)
            elif orig is None and bi == 0:
                u8_all = mesh_lib.gather_data_rows(self.mesh, u8)
                if self.writer:
                    imlog.log_images(step, u8_all)
            if not writes:
                return
            if metrics_hook is not None and "raw_image" in bmeta:
                raw = np.asarray(bmeta["raw_image"], np.float32)
                if raw.ndim == 4 and raw.shape[1] in (1, 3):
                    raw = raw.transpose(0, 2, 3, 1)  # torch-layout datasets
                metrics_hook.on_batch_end(u8, np.clip(raw * 255.0, 0, 255).astype(np.uint8))
            elif metrics_hook is not None and orig is not None:
                metrics_hook.on_batch_end(u8, orig)  # the original is the loader's image

        try:
            pipelined_map(batches(), dispatch, consume,
                          depth=int(data_cfg.get("pred_pipeline_depth", 1)))
            if metrics_hook is not None and metrics_hook.any_rank_has_updates():
                scores = metrics_hook.on_epoch_end()  # summed over the ranks
                if self.writer:
                    with open(os.path.join(self.workdir, "predict_metrics.json"), "w") as f:
                        json.dump({k: float(v) for k, v in scores.items()}, f)
        finally:
            if kept is not None:
                torch._foreach_copy_(list(self.model.parameters()), kept)
                quant.clear_quant_cache(self.model)  # it was the EMA's
            npz = hook.on_predict_end()  # waits for the image writes
        return npz
