"""The per-token rectified-flow decoder head (``deco_tpu/models/uniflow/flow_decoder.py``).

:class:`FlowDecoder`: the condition tokens go through
:class:`~deco_tpu_torch.models.uniflow.components.UniFlowNerfEmbedder`;
training draws a time per token (B, N), logit-normal with probability
``lognorm_mix_p`` (0.9) and uniform otherwise, and noise x0, forms
``x_t = t x1 + (1 - t) x0`` in fp32, and takes the MSE of the predicted
velocity against ``x1 - x0``; it also returns ``x1_pred = x_t + (1 - t) v``
in fp32. Sampling is the Euler loop over the host tables of
:func:`flow_decoder_timesteps` (``linear`` or ``pow_p``), time running from
0 to 1, with CFG against the ``mask_token`` (a parameter of zeros, kept in
the state dict even when CFG is off) inside the EDM-convention interval;
the null token goes through the same embedding as the condition, as in JAX.

The random draws come through ``draws`` (``t_normal``, ``t_mix`` and
``t_uniform`` of shape (B, N), ``x0`` of x1's shape; the parity tests hand
over the JAX package's) or from a ``torch.Generator``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from deco_tpu_torch.diffusion.training import draw
from deco_tpu_torch.parallel import mesh as mesh_lib
from deco_tpu_torch.models.uniflow.components import (
    TimeCondMLPAdaLN,
    UniFlowNerfEmbedder,
    l2p_transform,
)


def _edm_to_flow_convention(noise_level: float) -> float:
    return noise_level / (1 + noise_level)


def flow_decoder_timesteps(num_steps: int, schedule: str = "linear"):
    """(ts, dts) float32 tables; time runs from 0 to 1."""
    if schedule == "linear":
        ts = np.arange(1, num_steps + 1)[::-1] / num_steps
        dts = np.full(num_steps, 1.0 / num_steps)
    elif schedule.startswith("pow"):
        p = float(schedule.split("_")[1])
        ts = np.arange(0, num_steps + 1)[::-1] ** (1 / p) / num_steps ** (1 / p)
        dts = ts[:-1] - ts[1:]
        ts = ts[:-1]
    else:
        raise NotImplementedError(schedule)
    return (1 - ts).astype(np.float32), dts.astype(np.float32)


class FlowDecoder(nn.Module):
    def __init__(self, target_channels: int, z_channels: int, width: int, depth: int,
                 num_sampling_steps: int = 100, patch_size: int = 14, max_freqs: int = 32,
                 lognorm_mix_p: float = 0.9, dtype=torch.float32, param_dtype=None):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype)
        self.target_channels = target_channels
        self.num_sampling_steps = num_sampling_steps
        self.patch_size = patch_size
        self.lognorm_mix_p = lognorm_mix_p
        self.dtype = dtype
        self.nerf_embedder = UniFlowNerfEmbedder(z_channels, z_channels, max_freqs, **kw)
        self.net = TimeCondMLPAdaLN(target_channels, width, target_channels, z_channels, depth,
                                    **kw)
        self.mask_token = nn.Parameter(torch.zeros(1, 1, z_channels, dtype=torch.float32))

    def forward_train(self, x1, z, draws: Optional[dict] = None, generator=None) -> dict:
        """x1 (B, N, C) fp32 targets, z (B, N, z) conditions -> dict(mse_loss, pred)."""
        b, n, _ = x1.shape
        z = self.nerf_embedder(z)
        dev = x1.device
        t_log = torch.sigmoid(draw(draws, "t_normal", (b, n), True, generator, dev))
        t_mix = draw(draws, "t_mix", (b, n), False, generator, dev)
        t_uni = draw(draws, "t_uniform", (b, n), False, generator, dev)
        t = torch.where(t_mix <= self.lognorm_mix_p, t_log, t_uni)
        x0 = draw(draws, "x0", x1.shape, True, generator, dev)
        te = t[..., None]
        x_t = te * x1 + (1 - te) * x0
        v_pred = self.net(x_t.to(self.dtype), t * 1000.0, z)
        mse = (v_pred.float() - (x1 - x0).float()).square().mean()
        return dict(mse_loss=mse, pred=x_t + (1 - te) * v_pred.to(x_t.dtype))

    @torch.no_grad()
    def sample(self, z, noise=None, generator=None, schedule: str = "linear", cfg: float = 1.0,
               cfg_interval: Optional[tuple] = None, as_image: bool = True):
        """Euler sampling from ``noise`` (B, N, target), or a draw from
        ``generator``; returns the image (B, H, W, C) or the tokens."""
        b, n, _ = z.shape
        z_emb = self.nerf_embedder(z)
        ts, dts = flow_decoder_timesteps(self.num_sampling_steps, schedule)
        use_cfg = cfg != 1.0
        if use_cfg:
            null_emb = self.nerf_embedder(self.mask_token.to(z.dtype).expand(z.shape))
            on = np.ones_like(ts, bool)
            if cfg_interval is not None:
                lo = _edm_to_flow_convention(cfg_interval[0])
                hi = _edm_to_flow_convention(cfg_interval[1])
                on = (ts >= lo) & (ts <= hi)
            cfg_per_step = np.where(on, cfg, 1.0).astype(np.float32)
        if noise is None:
            noise = mesh_lib.sample(generator, (b, n, self.target_channels), z.device)
        x = noise.float()
        for i in range(len(ts)):
            tt = torch.full((b, n), float(ts[i] * np.float32(1000.0)), device=z.device)
            vc = self.net(x.to(self.dtype), tt, z_emb).float()
            if use_cfg:
                vu = self.net(x.to(self.dtype), tt, null_emb).float()
                vc = vu + float(cfg_per_step[i]) * (vc - vu)
            x = x + float(dts[i]) * vc
        return l2p_transform(x, self.patch_size) if as_image else x
