"""Analytic matmul FLOPs of the DeCo c2i workload, and H100 peak rates.

A copy of ``deco_tpu/utils/flops.py``'s counting (2*M*N*K per GEMM; norms,
softmax and elementwise work are left out, as is conventional for MFU),
with the H100's published peaks in place of the TPU's, for MFU and for
the roofline bounds of kernels.
"""

from __future__ import annotations

# per card: dense bf16 tensor-core FLOP/s and device-memory bytes/s
# (NVIDIA data sheets; the rates assume the card's full power limit)
CARD_PEAKS = {
    "H100 SXM": (989e12, 3.35e12),
    "H100 NVL": (835e12, 3.9e12),
    "H100 PCIe": (756e12, 2.0e12),
}


# per card: dense fp32 FLOP/s outside the tensor cores (NVIDIA data sheets)
CARD_FP32_PEAKS = {"H100 SXM": 67e12, "H100 NVL": 60e12, "H100 PCIe": 51e12}


def _card_key(card_name: str) -> str:
    name = card_name.upper()
    if "H100" not in name:
        raise ValueError(f"no peak rates on record for {card_name!r}")
    if "PCIE" in name:
        return "H100 PCIe"
    if "NVL" in name:
        return "H100 NVL"
    return "H100 SXM"  # "H100 80GB HBM3" is the SXM part


def card_fp32_peak(card_name: str) -> float:
    """fp32 FLOP/s outside the tensor cores for a card name from ``nvidia-smi``."""
    return CARD_FP32_PEAKS[_card_key(card_name)]


def card_peaks(card_name: str) -> tuple[float, float]:
    """(bf16 FLOP/s, bytes/s) for a card name as ``nvidia-smi`` reports it."""
    return CARD_PEAKS[_card_key(card_name)]


def dit_block_flops(tokens: int, hidden: int, mlp_hidden: int,
                    kv_tokens: int | None = None) -> float:
    """Matmul FLOPs of one adaLN DiT block forward, per batch element."""
    kv = kv_tokens if kv_tokens is not None else tokens
    qkv = 2 * tokens * hidden * 3 * hidden
    attn = 2 * 2 * tokens * kv * hidden  # QK^T and PV
    proj = 2 * tokens * hidden * hidden
    swiglu = 3 * 2 * tokens * hidden * mlp_hidden
    adaln = 2 * hidden * 6 * hidden  # on the per-sample condition
    return float(qkv + attn + proj + swiglu + adaln)


def deco_pixel_decoder_flops(num_patches: int, patch: int, width: int,
                             hidden: int, num_res_blocks: int,
                             out_channels: int = 3) -> float:
    """SimpleMLPAdaLN per-patch pixel decoder, per batch element."""
    px = patch * patch
    in_proj = 2 * px * 64 * width  # NerfEmbedder DCT basis (64) -> width
    cond = 2 * hidden * px * width  # cond_embed: z -> P^2 per-pixel conditions
    res = num_res_blocks * px * (2 * width * 3 * width + 2 * 2 * width * width)
    out = 2 * px * width * out_channels
    return float(num_patches * (in_proj + cond + res + out))


def deco_c2i_flops(image_size: int = 256, patch: int = 16,
                   hidden: int = 1152, num_cond_blocks: int = 28,
                   num_blocks: int = 31, hidden_x: int = 32) -> float:
    """Forward matmul FLOPs for one DeCo c2i image (one network call)."""
    tokens = (image_size // patch) ** 2
    mlp_hidden = int(2 / 3 * 4 * hidden)
    trunk = num_cond_blocks * dit_block_flops(tokens, hidden, mlp_hidden)
    dec = deco_pixel_decoder_flops(
        tokens, patch, hidden_x, hidden, num_blocks - num_cond_blocks)
    embed = 2 * tokens * (patch * patch * 3) * hidden
    return trunk + dec + embed


def sampler_flops_per_image(net_flops: float, num_steps: int,
                            cfg_batch_factor: float = 2.0) -> float:
    """FLOPs per generated image for an N-step sampler; ``cfg_batch_factor``
    is the mean network batch per image (2 for CFG on every step)."""
    return net_flops * num_steps * cfg_batch_factor


def train_flops_per_image(net_flops: float) -> float:
    """Training FLOPs per image: forward + backward = 3 x the forward's.
    Recompute under remat is not counted, so MFU is model FLOPs utilisation."""
    return 3.0 * net_flops


def mfu(images_per_sec: float, flops_per_image: float, peak_flops: float) -> float:
    return images_per_sec * flops_per_image / peak_flops
