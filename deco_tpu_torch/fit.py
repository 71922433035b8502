"""Class-to-image training with the port: DeCo-XL/16 at 256 px.

    python -m deco_tpu_torch.fit --preset deco_xl_256 --batch 32 --steps 5 \\
        --seed 0 [--warmup 2] [--no-freq-loss] [--no-remat] [--device cuda|cpu]

The counterpart of ``scripts/bench_train.py``. Builds ``DeCoC2I`` at the
preset's width with seeded random weights, fp32 parameters and bf16
compute, and trains it with ``configs_c2i/DeCo_XL_freq.yaml``'s objective
(``DeCoTrainer``: lognorm t, label dropout 0.2, the block-DCT frequency loss;
``--no-freq-loss`` gives ``DeCo_XL.yaml``'s), AdamW (lr 1e-4, weight decay
0) and EMA 0.9999, with per-block remat unless ``--no-remat``. The batches
are synthetic: images uniform in [-1, 1] from numpy, seeded, and labels
cycling over the classes (there is no dataset pipeline in the port yet).
Prints one JSON line: the per-step losses and grad norms of the timed steps,
s/step, trained images/s, training MFU, peak device memory and the card.
The ``tiny`` preset is a small configuration for drives on the CPU.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from deco_tpu_torch._device import card_info, resolve_device
from deco_tpu_torch.diffusion.scheduling import LinearScheduler
from deco_tpu_torch.diffusion.training import DeCoTrainer
from deco_tpu_torch.models.dit_c2i_deco import DeCoC2I, init_random_
from deco_tpu_torch.sample import PRESETS as SAMPLE_PRESETS
from deco_tpu_torch.train.state import TrainState
from deco_tpu_torch.train.train_step import make_train_step
from deco_tpu_torch.utils.flops import card_peaks, deco_c2i_flops, train_flops_per_image

# configs_c2i/DeCo_XL_freq.yaml: denoiser, trainer, optimizer, EMA, batch
_XL_TRAIN = dict(
    trainer=dict(lognorm_t=True, null_condition_p=0.2, freq_loss_weight=1.0,
                 freq_quality=85, freq_mode="inv_gamma"),
    lr=1e-4, weight_decay=0.0, ema_decay=0.9999, batch=32,
)
PRESETS = {
    "deco_xl_256": dict(model=SAMPLE_PRESETS["deco_xl_256"]["model"], image_size=256,
                        flops=dict(image_size=256), **_XL_TRAIN),
    # a small shape for drives on the CPU; not a configuration of the repo
    "tiny": dict(model=dict(in_channels=3, patch_size=4, num_groups=2, hidden_size=144,
                            hidden_size_x=16, num_blocks=4, num_cond_blocks=2, num_classes=10),
                 image_size=32,
                 flops=dict(image_size=32, patch=4, hidden=144, num_cond_blocks=2,
                            num_blocks=4, hidden_x=16),
                 **{**_XL_TRAIN, "batch": 4}),
}


def build(preset: str, device="cuda", seed: int = 0, freq_loss: bool = True,
          remat: bool = True, dtype=torch.bfloat16, **model_overrides):
    """(state, trainer, train_step) for ``preset``: the model with fp32
    parameters drawn from ``seed`` and ``dtype`` compute; fields in
    ``model_overrides`` replace the preset's (e.g. a cut depth)."""
    cfg = PRESETS[preset]
    model = DeCoC2I(**{**cfg["model"], **model_overrides}, dtype=dtype,
                    param_dtype=torch.float32, grad_checkpoint=remat, device=device)
    init_random_(model, seed)
    state = TrainState.create(model.train(), lr=cfg["lr"], weight_decay=cfg["weight_decay"])
    trainer = DeCoTrainer(scheduler=LinearScheduler(), enable_freq_loss=freq_loss,
                          **cfg["trainer"])
    return state, trainer, make_train_step(trainer, ema_decay=cfg["ema_decay"])


def synthetic_batches(count: int, batch: int, image_size: int, num_classes: int, seed: int,
                      device) -> list:
    """``count`` batches made on the host from ``seed`` and moved to ``device``:
    ``x`` uniform in [-1, 1] NHWC, labels cycling over the classes, and the
    null class as the uncondition."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(count):
        x = rng.uniform(-1.0, 1.0, (batch, image_size, image_size, 3)).astype(np.float32)
        labels = (np.arange(batch) + i * batch) % num_classes
        out.append(dict(x=torch.from_numpy(x).to(device),
                        condition=torch.from_numpy(labels).to(device),
                        uncondition=torch.full((batch,), num_classes, device=device)))
    return out


def train(state, train_step, batches, steps: int, generator) -> list:
    """Run ``steps`` steps over ``batches`` in turn; the metrics of each step."""
    return [train_step(state, batches[i % len(batches)], generator) for i in range(steps)]


def run(preset: str = "deco_xl_256", batch: int | None = None, steps: int = 5, warmup: int = 2,
        seed: int = 0, freq_loss: bool = True, remat: bool = True, device="cuda",
        **model_overrides) -> dict:
    """Build, warm up, time ``steps`` steps; the result line as a dict."""
    dev = resolve_device(device)
    cfg = PRESETS[preset]
    batch = batch or cfg["batch"]
    state, _, train_step = build(preset, dev, seed, freq_loss, remat, **model_overrides)
    num_classes = state.model.y_embedder.embedding_table.num_embeddings - 1
    batches = synthetic_batches(min(warmup + steps, 4), batch, cfg["image_size"],
                                num_classes, seed, dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    train(state, train_step, batches, warmup, gen)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    metrics = train(state, train_step, batches, steps, gen)
    losses = [float(m["loss"]) for m in metrics]  # the copy to the host waits for the device
    seconds = time.perf_counter() - t0
    result = {
        "preset": preset, "batch": batch, "steps": steps, "warmup": warmup,
        "freq_loss": freq_loss, "remat": remat, "losses": losses,
        "grad_norms": [float(m["grad_norm"]) for m in metrics],
        "params": sum(p.numel() for p in state.model.parameters()),
    }
    if dev.type == "cuda":
        card = card_info()
        flops = train_flops_per_image(deco_c2i_flops(**cfg["flops"]))
        images_per_s = batch * steps / seconds
        result.update(s_per_step=seconds / steps, images_per_s=images_per_s,
                      train_flops_per_image=flops,
                      mfu=images_per_s * flops / card_peaks(card)[0],
                      peak_mem_bytes=torch.cuda.max_memory_allocated(dev), device=card)
    else:  # host time only: no device metric is measured on the CPU
        result.update(host_s_per_step=seconds / steps, device="cpu")
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--preset", default="deco_xl_256", choices=sorted(PRESETS))
    ap.add_argument("--batch", type=int, default=None, help="default: the preset's")
    ap.add_argument("--steps", type=int, default=5, help="timed steps")
    ap.add_argument("--warmup", type=int, default=2, help="untimed steps first")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-freq-loss", action="store_true")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    print(json.dumps(run(args.preset, args.batch, args.steps, args.warmup, args.seed,
                         not args.no_freq_loss, not args.no_remat, args.device)))


if __name__ == "__main__":
    main()
