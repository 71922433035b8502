"""Class-to-image sampling with the port: the DeCo-XL/16 256 px main path.

    python -m deco_tpu_torch.sample --preset deco_xl_256 --num-images 8 \\
        --batch 8 --steps 50 --seed 0 --out samples.npz [--device cuda|cpu] \\
        [--weights checkpoint.pt]

Builds ``DeCoC2I`` at the preset's width with seeded random weights (or a
reference-layout checkpoint, see ``convert.load_checkpoint``), samples with
the Euler CFG sampler in bf16, and writes ``arr_0`` as uint8 NHWC to
``--out``. Image ``i`` is item ``i`` of the FID protocol (class ``i // 50``,
noise seed ``i % 50``), as in the CLI predict; ``--seed`` seeds the random
weights. Prints one JSON line with the throughput and the
card it ran on.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from deco_tpu_torch._device import card_info, resolve_device
from deco_tpu_torch.convert import load_checkpoint
from deco_tpu_torch.data.randn import ClassLabelRandomNDataset
from deco_tpu_torch.diffusion.sampling import EulerSampler
from deco_tpu_torch.diffusion.scheduling import LinearScheduler
from deco_tpu_torch.models.autoencoders import PixelAE, fp_to_uint8
from deco_tpu_torch.models.conditioners import LabelConditioner
from deco_tpu_torch.models.dit_c2i_deco import DeCoC2I, init_random_

# configs_c2i/DeCo_XL.yaml's denoiser and sampler (guidance 3.2 on (0.1, 1])
PRESETS = {
    "deco_xl_256": dict(
        model=dict(in_channels=3, patch_size=16, num_groups=16, hidden_size=1152,
                   hidden_size_x=32, num_blocks=31, num_cond_blocks=28,
                   num_classes=1000),
        image_size=256, guidance=3.2, guidance_interval=(0.1, 1.0),
    ),
}


def build_model(preset: str, device="cuda", dtype=torch.bfloat16, seed: int = 0,
                weights: str | None = None, **overrides) -> DeCoC2I:
    """The preset's ``DeCoC2I`` (fields in ``overrides`` replace the preset's)
    with seeded random weights, or the checkpoint at ``weights``."""
    kw = {**PRESETS[preset]["model"], **overrides}
    model = DeCoC2I(**kw, dtype=dtype, device=device).eval()
    if weights:
        model.load_state_dict(load_checkpoint(weights), strict=True)
    else:
        init_random_(model, seed)
    return model


def build_sampler(preset: str, steps: int) -> EulerSampler:
    cfg = PRESETS[preset]
    lo, hi = cfg["guidance_interval"]
    return EulerSampler(scheduler=LinearScheduler(), num_steps=steps,
                        guidance=cfg["guidance"], guidance_interval_min=lo,
                        guidance_interval_max=hi)


@torch.no_grad()
def generate(model: DeCoC2I, sampler: EulerSampler, num_images: int, batch: int,
             image_size: int, device="cuda", max_num_instances: int = 50000) -> torch.Tensor:
    """Sample the first ``num_images`` items of the FID protocol in batches:
    item ``i`` of ``ClassLabelRandomNDataset`` (class ``i // num_seeds``,
    noise seed ``i % num_seeds``, as the CLI predict pairs them). Returns the
    decoded float32 (N, H, W, C) on the CPU, nominally in [-1, 1]
    (``fp_to_uint8`` makes the stored form)."""
    dev = resolve_device(device)
    num_classes = model.y_embedder.embedding_table.num_embeddings - 1
    dataset = ClassLabelRandomNDataset(latent_shape=(model.in_channels, image_size, image_size),
                                       num_classes=num_classes,
                                       max_num_instances=max_num_instances)
    conditioner = LabelConditioner(num_classes)
    ae = PixelAE()
    out = []
    for start in range(0, num_images, batch):
        items = [dataset[i] for i in range(start, min(start + batch, num_images))]
        noise = torch.from_numpy(np.stack([latent for latent, _, _ in items])).to(dev)
        cond, uncond = conditioner([label for _, label, _ in items])
        x = sampler(model, noise, cond.to(dev), uncond.to(dev))
        out.append(ae.decode(x).cpu())
    return torch.cat(out)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--preset", default="deco_xl_256", choices=sorted(PRESETS))
    ap.add_argument("--num-images", type=int, default=8)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="samples.npz")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--weights", default=None, help="reference-layout .pt checkpoint")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    model = build_model(args.preset, device=dev, seed=args.seed, weights=args.weights)
    sampler = build_sampler(args.preset, args.steps)
    t0 = time.perf_counter()
    images = generate(model, sampler, args.num_images, args.batch,
                      PRESETS[args.preset]["image_size"], device=dev)
    seconds = time.perf_counter() - t0  # generate() ends in a copy to the host
    images = fp_to_uint8(images).numpy()
    np.savez(args.out, arr_0=images)
    print(json.dumps({
        "preset": args.preset, "images": int(images.shape[0]), "batch": args.batch,
        "steps": args.steps, "seconds": seconds,
        "images_per_s": images.shape[0] / seconds,
        "device": card_info() if dev.type == "cuda" else "cpu",
        "out": args.out,
    }))


if __name__ == "__main__":
    main()
