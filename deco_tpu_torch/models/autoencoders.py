"""Codecs (``deco_tpu/models/autoencoders.py``): the pixel-space ``PixelAE``
that DeCo diffuses in, ``fp_to_uint8``, and the latent wrappers
:class:`LatentAE` (SD-VAE) and :class:`DCLatentAE` (DC-AE), thin classes
around injected encode and decode functions: no SD-VAE or DC-AE weights are
in the repository, and the DC-AE network is ROADMAP §A 5."""

from __future__ import annotations

import torch


def fp_to_uint8(x):
    """[-1, 1] float -> [0, 255] uint8 (round half up, then truncate)."""
    return torch.clamp((x + 1) * 127.5 + 0.5, 0, 255).to(torch.uint8)


class PixelAE:
    """Identity scale/shift codec: DeCo diffuses in pixel space."""

    def __init__(self, scale: float = 1.0, shift: float = 0.0):
        self.scale = scale
        self.shift = shift

    def encode(self, x):
        return x / self.scale + self.shift

    def decode(self, x):
        return (x - self.shift) * self.scale


class LatentAE:
    """SD-VAE latent wrapper: ``encode`` is ``encode_fn(x) * scale + shift``
    (with ``precompute`` the input is a latent already, only scaled) and
    ``decode`` is ``decode_fn((z - shift) / scale)``; a missing function
    raises."""

    def __init__(self, encode_fn=None, decode_fn=None, scale: float = 0.18215,
                 shift: float = 0.0, precompute: bool = False):
        self.scale = scale
        self.shift = shift
        self._encode_fn = encode_fn
        self._decode_fn = decode_fn
        self.precompute = precompute

    def encode(self, x):
        if self.precompute:
            return x * self.scale + self.shift
        if self._encode_fn is None:
            raise NotImplementedError(
                f"{type(self).__name__} needs converted autoencoder weights (encode_fn)")
        return self._encode_fn(x) * self.scale + self.shift

    def decode(self, x):
        if self._decode_fn is None:
            raise NotImplementedError(
                f"{type(self).__name__} needs converted autoencoder weights (decode_fn)")
        return self._decode_fn((x - self.shift) / self.scale)


class DCLatentAE(LatentAE):
    """DC-AE (SANA AutoencoderDC f32c32) latent wrapper."""

    def __init__(self, encode_fn=None, decode_fn=None, scale: float = 0.41407,
                 shift: float = 0.0, precompute: bool = False):
        super().__init__(encode_fn, decode_fn, scale, shift, precompute)

    @classmethod
    def from_torch_state(cls, sd, scale=0.41407, shift=0.0, dtype=None,
                         attention_head_dim: int = 32):
        raise NotImplementedError(
            "DCLatentAE.from_torch_state: the DC-AE network is not ported to deco_tpu_torch "
            "yet, ROADMAP §A 5 (DC-AE)")
