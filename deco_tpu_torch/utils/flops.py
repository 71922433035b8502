"""Analytic matmul FLOPs of the c2i models (DeCo, the baseline DiT, PixNerd),
of the DINOv2 tower, of ReCo and of UniFlow, and H100 peak rates.

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


# per card: dense fp32 FLOP/s outside the tensor cores, and dense TF32
# FLOP/s on the tensor cores (NVIDIA data sheets)
CARD_FP32_PEAKS = {"H100 SXM": 67e12, "H100 NVL": 60e12, "H100 PCIe": 51e12}
CARD_TF32_PEAKS = {"H100 SXM": 495e12, "H100 NVL": 417.5e12, "H100 PCIe": 378e12}


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


def card_tf32_peak(card_name: str) -> float:
    """Dense TF32 tensor-core FLOP/s for a card name from ``nvidia-smi``."""
    return CARD_TF32_PEAKS[_card_key(card_name)]


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


def baseline_dit_flops(image_size: int = 256, patch: int = 16, hidden: int = 1024,
                       num_blocks: int = 24, in_channels: int = 3) -> float:
    """Forward matmul FLOPs for one ``BaselineDiT`` image: the patch embed,
    the trunk and the final layer back to patch pixels."""
    tokens = (image_size // patch) ** 2
    p2c = patch * patch * in_channels
    trunk = num_blocks * dit_block_flops(tokens, hidden, int(2 / 3 * 4 * hidden))
    final = 2 * hidden * 2 * hidden + 2 * tokens * hidden * p2c
    return trunk + 2 * tokens * p2c * hidden + final


def nerf_decoder_flops(num_patches: int, patch: int, hidden_x: int, hidden: int,
                       num_blocks: int, mlp_ratio: int, out_channels: int = 3,
                       in_channels: int = 3, basis: int = 64) -> float:
    """PixNerd's hyper-network decoder, per batch element: the NerfEmbedder,
    each NerfBlock's weight generator (from the patch token) and its two
    per-patch products, and the final linear."""
    px = patch * patch
    wide = hidden_x * mlp_ratio
    embed = 2 * px * (in_channels + basis) * hidden_x
    block = 2 * hidden * 2 * hidden_x * wide + 2 * 2 * px * hidden_x * wide
    return float(num_patches * (embed + num_blocks * block + 2 * px * hidden_x * out_channels))


def pixnerd_c2i_flops(image_size: int = 256, patch: int = 16, hidden: int = 1024,
                      num_cond_blocks: int = 22, num_blocks: int = 24, hidden_x: int = 64,
                      mlp_ratio: int = 2) -> float:
    """Forward matmul FLOPs for one ``PixNerdC2I`` image."""
    tokens = (image_size // patch) ** 2
    trunk = num_cond_blocks * dit_block_flops(tokens, hidden, int(2 / 3 * 4 * hidden))
    dec = nerf_decoder_flops(tokens, patch, hidden_x, hidden, num_blocks - num_cond_blocks,
                             mlp_ratio)
    return trunk + dec + 2 * tokens * (patch * patch * 3) * hidden


def vit_flops(image_size: int = 224, patch: int = 14, hidden: int = 768,
              num_layers: int = 12, mlp_ratio: int = 4) -> float:
    """Forward matmul FLOPs for one image through a ViT (DINOv2 ViT-B/14 at
    224 px by default: 257 tokens): patch embed, qkv, attention, proj and
    the MLP of each layer."""
    tokens = (image_size // patch) ** 2 + 1
    per_layer = (2 * tokens * hidden * 3 * hidden + 2 * 2 * tokens * tokens * hidden
                 + 2 * tokens * hidden * hidden + 2 * 2 * tokens * hidden * mlp_ratio * hidden)
    return float(num_layers * per_layer + 2 * (tokens - 1) * 3 * patch * patch * hidden)


def reco_flops(image_size: int = 224, patch: int = 14, vit_hidden: int = 1024,
               vit_layers: int = 24, hidden: int = 1024, num_blocks: int = 6,
               hidden_x: int = 32, num_res_blocks: int = 3, latent_channel: int = 32,
               num_learnable_tokens: int = 16) -> float:
    """Forward matmul FLOPs for one ``ReCoModel`` row (a network call on one
    image with its condition image): the InternViT tower at its
    ``select_layer`` depth, the latent projector, the ``s_embedder``, the
    plain DiT blocks over the learnable and latent tokens (fused SwiGLU of
    exact width 4 x hidden, no adaLN) and the per-patch pixel decoder
    (``ReCo_large.yaml`` at 224 px by default: ~0.224 TFLOP)."""
    patches = (image_size // patch) ** 2
    tokens = patches + num_learnable_tokens
    block = (2 * tokens * hidden * 3 * hidden + 2 * 2 * tokens * tokens * hidden
             + 2 * tokens * hidden * hidden + 3 * 2 * tokens * hidden * 4 * hidden)
    projector = 2 * patches * vit_hidden * (vit_hidden + latent_channel)
    embed = 2 * patches * latent_channel * hidden
    return (vit_flops(image_size, patch, vit_hidden, vit_layers) + projector + embed
            + num_blocks * block
            + deco_pixel_decoder_flops(patches, patch, hidden_x, hidden, num_res_blocks))


def _plain_block_flops(tokens: int, width: int, causal: bool = False) -> float:
    """One ``PlainDiTBlock`` forward: qkv, attention (half of QK^T and PV when
    causal: the kernel visits the tiles up to the diagonal), proj, the fused
    SwiGLU of exact width 4 x width (three width x 4 width matrices)."""
    attn = 2 * 2 * tokens * tokens * width / (2 if causal else 1)
    return 2 * tokens * width * 3 * width + attn + 2 * tokens * width * width \
        + 3 * 2 * tokens * width * 4 * width


def _flow_head_flops(tokens: int, target: int, z: int, width: int, depth: int,
                     max_freqs: int = 32) -> float:
    """One ``FlowDecoder`` network call: the NerfEmbedder, the input, time
    and condition projections, ``depth`` gated res blocks (adaLN 3 x width,
    two width x width linears) and the gated final layer."""
    embed = 2 * tokens * (z + max_freqs**2) * z
    proj = 2 * tokens * (target * width + 256 * width + width * width + z * width)
    blocks = depth * 2 * tokens * (3 * width * width + 2 * width * width)
    final = 2 * tokens * (2 * width * width + width * target)
    return float(embed + proj + blocks + final)


def uniflow_flops(image_size: int = 224, patch: int = 14, vit_hidden: int = 1024,
                  vit_layers: int = 24, llm_hidden: int = 1536, depth: int = 6,
                  decoder_layers: int = 12) -> float:
    """Forward matmul FLOPs of ``UniFlowVision.forward_loss`` for one image:
    both ViTs, the latent projector, ``mlp1`` twice on the semantic branch,
    each trunk and one call of each flow head. A train step is 3 x this: the
    frozen towers' gradients are computed too
    (``uniflow_internvit_2b_base.yaml`` at 224 px: ~0.363 TFLOP)."""
    n = (image_size // patch) ** 2
    vh = vit_hidden
    encoder = vit_flops(image_size, patch, vh, vit_layers) + vit_flops(image_size, patch, vh, 4)
    projector = 2 * n * vh * vh * 2 + 3 * 10 * n * vh * vh + 6 * n * vh * vh \
        + 2 * (n // 4) * 4 * vh * 256
    mlp1 = 2 * (n // 4) * (4 * vh * llm_hidden + llm_hidden * llm_hidden)
    m, w = n // 4, 2 * vh
    semantic = (mlp1 + 2 * m * (256 * 4 * vh + 4 * vh * w)
                + depth * _plain_block_flops(m, w, causal=True)
                + _flow_head_flops(m, 4 * vh, w, 2048, 4))
    pixel = (2 * n * (64 * 4 * vh + 4 * vh * vh) + depth * _plain_block_flops(n, vh)
             + _flow_head_flops(n, 3 * patch * patch, vh, vh, decoder_layers))
    return float(encoder + projector + mlp1 + semantic + pixel)
