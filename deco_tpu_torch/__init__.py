"""PyTorch + CUDA port of ``deco_tpu`` for NVIDIA Hopper (H100).

The JAX package ``deco_tpu`` stays the reference; this package mirrors its
file names so each counterpart is easy to find. It imports torch, numpy and
the standard library only. Every TPU (Pallas) kernel on a ported path is a
CUDA C++ kernel under ``csrc/``, built with ``nvcc`` at first use
(``ops/_build.py``); each kernel's plain PyTorch version sits beside its
wrapper and serves CPU tensors.

Ported so far: DeCo-XL/16 class-to-image sampling (the 50-step Euler CFG
sampler over ``DeCoC2I``) and its training (``DeCoTrainer`` with the
block-DCT frequency loss, AdamW, EMA, per-block remat: ``fit.py``), with the
flash-attention forward (with and without logsumexp), its dQ and dK/dV
backward and the fused frequency-weighted MSE as kernels; and both run
from the reference YAML configs through ``python -m deco_tpu_torch.cli``
(image-folder data, loader, step checkpoints, hooks, the run loop), with FID
scoring at 512 px; and DeCo-XXL/16 text-to-image serving (``DeCoT2I``, the
text conditioners, ``python -m deco_tpu_torch.serve``, and the DPG/GenEval
predict through the CLI), whose joint attention runs the same forward kernel;
then the other c2i families with REPA, ReCo, the VAE-GAN and DC-AE eval, and
UniFlow, whose causal semantic trunk runs the kernels' causal
instantiations.
"""
