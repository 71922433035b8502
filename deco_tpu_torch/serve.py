"""Text-to-image serving: the Pipeline and its command line (``deco_tpu/serve.py``).

    python -m deco_tpu_torch.serve --config configs_t2i/sft_res512.yaml \\
        [--ckpt_path CKPT] [--prompt TEXT ...] [--negative_prompt TEXT] \\
        [--height 512] [--width 512] [--num_steps 25] [--cfg 4.0] [--seed 0] \\
        [--out_dir ./serve_out] [--device cuda|cpu] [--gradio] [--a.b.c=value ...]

A prompt goes in and images come out: :class:`Pipeline` encodes the prompts
and the negative prompt (the uncondition) with the config's conditioner,
samples with the Adams-Lagrange sampler of the request's order, steps, CFG
scale and time shift, and returns uint8 images and, on request, the
denoising trajectory (the noise and the x after each step). Any size
rounded down to a multiple of 32 is served: the model's extrapolating RoPE
is stretched by ``patch_scaling_hw = (H / base, W / base)``. ``main``
writes ``sample_{i}.png`` and ``traj_{i}.png``, the trajectory as an
animated PNG (100 ms a frame, looping). ``--key=value`` overrides a config
entry by its dotted path, as in ``deco_tpu_torch.cli``.

Departures from the JAX package: the noise is drawn from a CPU
``torch.Generator(seed)`` and moved to the device, so the card and the CPU
start from the same noise (it cannot equal ``jax.random.normal``); images
are numpy arrays rather than PIL images, and trajectories animated PNGs
rather than GIFs, whose palette would quantise the frames.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

import torch

from deco_tpu_torch._device import resolve_device
from deco_tpu_torch.config import registry
from deco_tpu_torch.diffusion.adam_sampling import AdamLMSampler
from deco_tpu_torch.diffusion.scheduling import LinearScheduler
from deco_tpu_torch.models.autoencoders import fp_to_uint8
from deco_tpu_torch.utils import png


class Pipeline:
    """(vae, denoiser, conditioner) serving prompts at any size; the
    denoiser holds its weights on its device."""

    # FIFO bound on the samplers kept per (size, protocol)
    _SAMPLER_CACHE_MAX = 16

    def __init__(self, vae, denoiser, conditioner, scheduler=None, base_resolution: int = 512):
        self.vae = vae
        self.denoiser = denoiser
        self.conditioner = conditioner
        self.scheduler = scheduler or LinearScheduler()
        self.base_resolution = base_resolution
        self.device = next(denoiser.parameters()).device
        self._sampler_cache: dict = {}

    def _get_sampler_fn(self, height, width, num_steps, order, cfg, timeshift,
                        dispatch_chunks=0):
        """``run(noise, cond, uncond, generator) -> (x, x_trajs)`` for one
        request shape and protocol, cached (FIFO, at most 16)."""
        key = (height, width, num_steps, order, cfg, timeshift, dispatch_chunks)
        if key in self._sampler_cache:
            return self._sampler_cache[key]
        while len(self._sampler_cache) >= self._SAMPLER_CACHE_MAX:
            self._sampler_cache.pop(next(iter(self._sampler_cache)))
        sampler = AdamLMSampler(scheduler=self.scheduler, order=order, num_steps=num_steps,
                                guidance=cfg, timeshift=timeshift)
        kw = {}
        if hasattr(self.denoiser, "patch_scaling_hw"):  # the arbitrary-size RoPE stretch
            kw["patch_scaling_hw"] = (height / self.base_resolution, width / self.base_resolution)

        def net(x, t, y):
            return self.denoiser(x, t, y, **kw)

        if dispatch_chunks:
            def run(noise, cond, uncond, generator=None):
                out = sampler.sample_chunked(net, noise, cond, uncond, generator,
                                             num_dispatches=dispatch_chunks)
                return out, out[None]
        else:
            def run(noise, cond, uncond, generator=None):
                return sampler(net, noise, cond, uncond, generator=generator,
                               return_x_trajs=True)

        self._sampler_cache[key] = run
        return run

    @torch.no_grad()
    def __call__(self, prompts: List[str], negative_prompt: str = "", height: int = 512,
                 width: int = 512, num_steps: int = 25, order: int = 2, cfg: float = 4.0,
                 timeshift: float = 3.0, seed: int = 0, return_trajectories: bool = False,
                 dispatch_chunks: int = 0):
        """(B, H, W, 3) uint8 images as a list of numpy arrays, and with
        ``return_trajectories`` each prompt's ``num_steps + 1`` frames."""
        height = max((height // 32) * 32, 32)
        width = max((width // 32) * 32, 32)
        if dispatch_chunks and return_trajectories:
            raise ValueError("dispatch_chunks does not collect trajectories; "
                             "use dispatch_chunks=0 for trajectory animations")
        cond, uncond = self.conditioner(prompts, {"negative_prompt": negative_prompt})
        gen = torch.Generator().manual_seed(seed)
        noise = torch.randn((len(prompts), height, width, 3), generator=gen).to(self.device)
        run = self._get_sampler_fn(height, width, num_steps, order, cfg, timeshift,
                                   dispatch_chunks)
        out, x_trajs = run(noise, cond.to(self.device), uncond.to(self.device),
                           torch.Generator(device=self.device).manual_seed(seed + 1))
        images = list(fp_to_uint8(self.vae.decode(out)).cpu().numpy())
        if not return_trajectories:
            return images
        trajs = fp_to_uint8(torch.clamp(x_trajs, -1, 1)).cpu().numpy()
        return images, [[trajs[s, b] for s in range(trajs.shape[0])] for b in range(len(prompts))]


def load_pipeline(config, ckpt_path: Optional[str] = None, use_ema: bool = True,
                  device="cuda", seed: int = 0) -> Pipeline:
    """A Pipeline from a t2i config (a YAML path or its dict) on ``device``:
    the denoiser loads the port's step checkpoints when ``ckpt_path`` is a
    directory (``train/checkpoint.py``), a reference-layout ``.ckpt``/``.pt``
    when it is a file (``convert.load_checkpoint``, ``ema_denoiser.*`` when
    ``use_ema``), and otherwise draws the JAX initializers' distributions
    from ``seed``."""
    from deco_tpu_torch.convert import load_checkpoint
    from deco_tpu_torch.models.dit_c2i_deco import init_like_jax_
    from deco_tpu_torch.train.checkpoint import CheckpointManager

    dev = resolve_device(device)
    if isinstance(config, str):
        config = registry.load_yaml(config)
    model_cfg = config["model"]
    node = model_cfg["denoiser"]
    denoiser = registry.instantiate(
        {**node, "init_args": {**(node.get("init_args") or {}), "device": str(dev)}}).eval()
    if ckpt_path and os.path.isdir(ckpt_path):
        CheckpointManager(ckpt_path, 0).restore_params(denoiser, use_ema=use_ema)
    elif ckpt_path:
        denoiser.load_state_dict(load_checkpoint(ckpt_path, ema=use_ema), strict=True)
    else:
        init_like_jax_(denoiser, seed)
    return Pipeline(registry.instantiate(model_cfg["vae"]), denoiser,
                    registry.instantiate(model_cfg["conditioner"]))


def serve_gradio(pipeline: Pipeline, port: int = 7860):
    try:
        import gradio as gr
    except ImportError as e:
        raise RuntimeError(
            "gradio is not installed in this environment; use the CLI "
            "generation path (python -m deco_tpu_torch.serve --prompt ...)"
        ) from e

    def generate(prompt, negative, height, width, steps, cfg, seed):
        imgs, _ = pipeline([prompt] * 2, negative_prompt=negative, height=int(height),
                           width=int(width), num_steps=int(steps), cfg=float(cfg),
                           seed=int(seed), return_trajectories=True)
        return imgs

    demo = gr.Interface(
        fn=generate,
        inputs=[
            gr.Textbox(label="prompt"),
            gr.Textbox(label="negative prompt", value=""),
            gr.Slider(256, 1024, 512, step=32, label="height"),
            gr.Slider(256, 1024, 512, step=32, label="width"),
            gr.Slider(1, 100, 25, step=1, label="steps"),
            gr.Slider(1.0, 10.0, 4.0, label="cfg"),
            gr.Number(value=0, label="seed"),
        ],
        outputs=gr.Gallery(label="samples"),
    )
    demo.launch(server_port=port)


def main(argv=None):
    from deco_tpu_torch.cli import parse_overrides

    p = argparse.ArgumentParser(prog="deco_tpu_torch.serve")
    p.add_argument("--config", required=True)
    p.add_argument("--ckpt_path", default=None)
    p.add_argument("--prompt", action="append", default=None)
    p.add_argument("--negative_prompt", default="")
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--num_steps", type=int, default=25)
    p.add_argument("--cfg", type=float, default=4.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out_dir", default="./serve_out")
    p.add_argument("--gradio", action="store_true")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args, unknown = p.parse_known_args(argv)
    config = registry.apply_overrides(registry.load_yaml(args.config), parse_overrides(unknown))
    pipeline = load_pipeline(config, args.ckpt_path, device=args.device)
    if args.gradio:
        serve_gradio(pipeline)
        return None
    prompts = args.prompt or ["a photo of a cat"]
    os.makedirs(args.out_dir, exist_ok=True)
    imgs, trajs = pipeline(prompts, negative_prompt=args.negative_prompt, height=args.height,
                           width=args.width, num_steps=args.num_steps, cfg=args.cfg,
                           seed=args.seed, return_trajectories=True)
    paths = []
    for i, (img, frames) in enumerate(zip(imgs, trajs)):
        paths.append(os.path.join(args.out_dir, f"sample_{i}.png"))
        png.write(paths[-1], img)
        png.write_apng(os.path.join(args.out_dir, f"traj_{i}.png"), frames, delay_ms=100)
    print(f"wrote {len(imgs)} samples to {args.out_dir}")
    return paths


if __name__ == "__main__":
    main()
