"""DC-AE decoder reconstruction eval (``deco_tpu/eval_dcae.py``).

A frozen InternVL vision encoder (``InternVLVision``, the default
InternViT-300M widths) and a DC-AE decoder eval model
(``DCAEDecoderEval``) reconstruct an image folder; each output is cropped
to the input's size from the top-left corner and PSNR and SSIM are the
batch means of the per-image scores, averaged over the batches. No encoder
weights are in the repository: both networks are drawn from ``seed`` (the
decoder loaded from ``--ckpt_path`` where given: a torch file holding its
state dict, or a dict with a ``decoder`` entry).

    python -m deco_tpu_torch.eval_dcae --image_root FOLDER [--resolution 224]
        [--batch_size 4] [--max_batches 8] [--ckpt_path decoder.pt]
        [--llm_hidden_size 1024] [--device cuda|cpu]

Prints one JSON line ``{"psnr": ..., "ssim": ..., "num_batches": ...}``.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch


@torch.no_grad()
def evaluate(image_root: str, resolution: int = 224, batch_size: int = 4, max_batches: int = 8,
             ckpt_path: str = None, llm_hidden_size: int = 1024, seed: int = 0, device="cuda",
             encoder=None, decoder=None) -> dict:
    """``encoder``/``decoder`` replace the seeded networks (the tests pass
    small ones)."""
    from deco_tpu_torch._device import resolve_device
    from deco_tpu_torch.data.imagenet import PixImageNet
    from deco_tpu_torch.data.loader import ShardedLoader
    from deco_tpu_torch.models import vae_models
    from deco_tpu_torch.models.internvl import InternVLVision
    from deco_tpu_torch.models.uniflow.vit import ViTConfig
    from deco_tpu_torch.train import metrics as M

    dev = resolve_device(device)
    if encoder is None:
        encoder = vae_models.init_like_jax_(InternVLVision(
            vit=ViTConfig(), llm_hidden_size=llm_hidden_size, device=dev), seed)
    if decoder is None:
        decoder = vae_models.init_like_jax_(vae_models.DCAEDecoderEval(
            llm_hidden_size=llm_hidden_size, device=dev), seed + 1)
        if ckpt_path:
            sd = torch.load(ckpt_path, map_location="cpu", weights_only=True)
            decoder.load_state_dict(sd.get("decoder", sd))
    encoder.eval()
    decoder.eval()
    loader = ShardedLoader(PixImageNet(image_root, resolution=resolution), batch_size,
                           shuffle=False, num_workers=2)
    psnrs, ssims = [], []
    for bi, (bx, _, _) in enumerate(loader):
        if bi >= max_batches:
            break
        x = torch.as_tensor(bx).to(dev)
        out = decoder(encoder(x))
        h, w = min(out.shape[1], x.shape[1]), min(out.shape[2], x.shape[2])
        out01 = torch.clamp(out[:, :h, :w].float() * 0.5 + 0.5, 0, 1) * 255
        ref01 = torch.clamp(x[:, :h, :w] * 0.5 + 0.5, 0, 1) * 255
        psnrs.append(float(M.psnr(out01, ref01)))
        ssims.append(float(M.ssim(out01, ref01)))
    result = {"psnr": float(np.mean(psnrs)) if psnrs else float("nan"),
              "ssim": float(np.mean(ssims)) if ssims else float("nan"),
              "num_batches": len(psnrs)}
    print(json.dumps(result))
    return result


def main(argv=None):
    p = argparse.ArgumentParser(prog="deco_tpu_torch.eval_dcae")
    p.add_argument("--image_root", required=True)
    p.add_argument("--resolution", type=int, default=224)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--max_batches", type=int, default=8)
    p.add_argument("--ckpt_path", default=None)
    p.add_argument("--llm_hidden_size", type=int, default=1024)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    return evaluate(args.image_root, args.resolution, args.batch_size, args.max_batches,
                    args.ckpt_path, args.llm_hidden_size, device=args.device)


if __name__ == "__main__":
    main()
