"""Smoke run of the PyTorch port (``deco_tpu_torch``) on one NVIDIA Hopper card.

    python3 chip_smoke.py [--seed N]   # from the repository root; needs CUDA and nvcc

Drives the port's main paths at the full width of DeCo-XL/16, class-to-image
sampling (``configs_c2i/DeCo_XL.yaml``) and training
(``configs_c2i/DeCo_XL_freq.yaml``) at 256 px, and training, sampling and
FID scoring at 512 px (``configs_c2i/DeCo_XL_512.yaml``), and text-to-image
serving, prompt-set predict and training with DeCo-XXL/16
(``configs_t2i/sft_res512.yaml``), the other c2i families with the REPA
objectives (Baseline-DiT-L/16, PixNerd-L/16, DeCo-L/16 with the DINOv2
tower), ReCo image reconstruction (``configs_c2i/ReCo_large.yaml``, the
InternViT tower), the VAE-GAN and DC-AE eval (``configs/vae_*.yaml``,
the DC-AE decoder) and UniFlow (``configs_flow/uniflow_*.yaml``), and holds each hand-written kernel against its plain
PyTorch version. Phases, in the order they run:

1. build: compile every ``deco_tpu_torch/csrc/*.cu`` with nvcc (one process
   per source, started together); print the card's name and power limit.
2. kernel: the flash-attention forward against its plain version at the
   sampling shape and at ragged, cross-length, other-head-dim and long
   shapes, and bit-identical over two runs at each; time the kernel, the
   plain version, each SDPA backend pinned in turn (flash, efficient,
   cuDNN; the fastest is the yardstick, and the port never calls SDPA) and
   the roofline bound, at the sampling shape and at 512 px's (B*H 192,
   N = 1024).
3. kernels_train: the forward with logsumexp, the dQ backward (which also
   computes delta = rowsum(dO * O)), the dK/dV backward and the
   frequency-weighted MSE against their plain versions at the training
   shape and at ragged, cross-length, other-head-dim and long shapes; the
   forward with lse, the backward (dQ, delta, dK, dV) and the frequency MSE
   bit-identical over two runs, the frequency MSE also at W = 2048 and
   W = 520. One line each for the forward's, the backward's and the
   frequency MSE's registers, spills and shared memory from the build log,
   with their resident CTAs per SM from the CUDA runtime. Times at the
   training shape and at N = 4096 beside the plain versions, the bounds and
   the library yardsticks (each SDPA backend's forward with logsumexp, and
   SDPA's autograd backward), and the forward without lse at N = 4096;
   also held and timed at 512 px's training shape (B*H 256, N = 1024).
4. model: one full-width DeCo-XL/16 forward at batch 2: finite, and exactly
   one attention launch per trunk block.
5. slice vs plain: a 4-block trunk, full widths, 8 CFG steps, the same
   weights and noise on the card (kernel) and on the CPU (plain versions),
   both in bf16; the final images agree within the stated tolerance.
6. train slice vs plain: one training step of the same cut-depth model at
   batch 2 on the card and on the CPU, both bf16 compute with fp32
   parameters, the same weights, batch and draws: loss, gradients and the
   parameter update agree within the stated gates.
7. sample: the sampling path through ``deco_tpu_torch.sample.generate``:
   50 Euler steps, CFG 3.2 on (0.1, 1], batch 8; images finite, the launch
   count exact; throughput, time per step, MFU and a device-time breakdown
   of one network call.
8. train: the training path through ``deco_tpu_torch.fit`` at batch 32 with
   full remat, 2 warm-up and 5 timed steps: finite losses, a positive grad
   norm, parameters moved and the EMA moved by the rule e*d + p*(1-d), the
   exact launches per step; s/step, images/s, MFU, peak memory and a
   device-time breakdown of one step.
9. cli: the entry point users run, ``deco_tpu_torch.cli``, on
   ``configs_c2i/DeCo_XL_freq.yaml`` at full width, its trunk cut to 4 of
   28 blocks (``CLI_DEPTH``: the script keeps its disk writes under 45 GiB,
   which the full-depth checkpoints of phases 9, 10 and 12-15 would pass). A
   PNG folder (2 classes x 32 images of 320x288 and 288x384 from
   ``--seed``) under ``build/chip_smoke_cli/``; ``fit`` for 3 steps at
   batch 32 with full remat: finite losses in ``metrics.jsonl``, 8 / 4 /
   4 / 1 launches a step, a final checkpoint with every key (its bytes and
   save time); ``predict`` from it, one batch of 20 with 100 Euler steps
   and CFG 3.2 on (0.1, 1]: a non-constant uint8 (20, 256, 256, 3)
   ``output.npz``, the FID protocol's file names ``0_0`` ... ``0_9``,
   exactly 400 forward launches, and the EMA weights loaded equal to those saved. Step times,
   s/step, the device's idle share and images/s; the folder is deleted.
10. cli_512: DeCo-XL/16 at 512 px end to end through the CLI and the
   eval entry points. ``fit`` on ``configs_c2i/DeCo_XL_512.yaml``
   unmodified but for the image folder (2 x 48 PNGs of 576x544 and
   544x640), the work directory, 3 steps and its trunk, cut to 4 of 28
   blocks (``CLI_512_DEPTH``, for the disk-write budget, as phase 9's):
   batch 16 x accumulation 2, ``decoder_chunks`` 8, full remat, exactly
   16 / 8 / 8 / 0 launches a step; s/step, idle share, peak memory. One
   more step each under ``trunk_remat_policy`` "attn" (8 forward-with-lse
   launches), "dots", and with ``decoder_chunks`` 0 (the peak memory
   chunking saves). ``predict`` from the fit's checkpoint: one batch of 6,
   100 Euler steps, CFG 5.0 on (0.1, 1], a (6, 512, 512, 3) uint8 npz,
   400 forward launches. Then ``eval_fid`` and ``ComputeMetricsHook`` on the card
   against a reference batch cropped from the folder, with the seed-0
   random tower, held against the same computations on the CPU; what TF32
   convolutions would change; the tower's images/s at batch 64.
11. t2i: DeCo-XXL/16 text-to-image serving (``configs_t2i/sft_res512.yaml``,
   1.12B parameters, 24 heads of 64). ``t2i_kernel``: the flash forward at
   the D = 64 shapes of the joint attention (image queries over 1,024 image
   and 128 text keys), the text refinement (128 x 128) and a ragged
   544x480 canvas (1,020 queries over 1,148 keys), at the serve and the
   CLI predict batch, against its plain version, timed beside bound and
   cuDNN. ``t2i_slice_vs_plain``: a 2 joint + 1 text block model at full
   width, 4 AdamLM steps on a 512x512 and the 544x480 canvas, card against
   CPU (both bf16), 12 launches a canvas. ``t2i_serve``:
   ``serve.load_pipeline`` with random weights and the hash text encoder,
   2 prompts at 512x512, 25 steps, order 2, CFG 4.0, time shift 3.0, with
   trajectories: exactly 500 launches a call, s/image, images/s, a
   network call's device time by kind, idle share, peak memory, the
   trajectory's 26 frames back from the APNG; then ``serve.main`` once.
   ``t2i_predict``: ``cli predict`` on the config, one batch of 8 (2 DPG
   prompts x 4 seeds), 500 launches, the 8 PNGs. The files go under
   ``build/chip_smoke_t2i/``, which is deleted.
12. t2i_fit: DeCo-XXL/16 text-to-image training on
   ``configs_t2i/sft_res512.yaml``. ``t2i_train_kernels``: the forward with
   lse, dQ and dK/dV at D = 64 at the training shapes of microbatch 16
   (joint: 1,024 queries over 1,152 keys; the 544x480 canvas: 1,020 over
   1,148; text: 128 x 128) against their plain versions, bit-identical over
   two runs, timed beside bound, plain versions and SDPA.
   ``t2i_train_slice_vs_plain``: one training step of a 2 joint + 1 text
   block model at full width (batch 2, 512 px), card against CPU: the loss
   and the gradients, those of every ``kv_y`` and of the ``y_embedder`` by
   name. ``t2i_fit``: ``cli fit`` on the YAML as shipped (batch 16 x
   accumulation 4, no remat) but for the folder (64 seeded PNG + caption
   pairs of 512-640 px, non-square), the work directory and 3 steps:
   finite losses, exactly 80 / 80 / 80 forward-with-lse / dQ / dK-dV
   launches a step, s/step, images/s, MFU, idle share, peak memory and the
   18 GB checkpoint's save time; then one more step each without and with
   ``grad_checkpoint`` (80 and 160 forward-with-lse launches) for the
   memory and time the remat trades; then ``cli predict`` from the
   checkpoint, one DPG batch of 8 with 500 forward launches. The files go
   under ``build/chip_smoke_t2i_fit/``, which is deleted.
13. c2i_families: the other c2i families and the REPA objectives at full
   width. ``fp32_attention``: the fp32 forward (the DINOv2 tower's
   attention, D = 64) against its plain version at B*H 384 and 1,536 with
   N = 257, at N = 1,025 and a ragged 17, bit-identical over two runs,
   timed beside its bound at the fp32 rate, the plain version and fp32 SDPA;
   the fp32 forward with lse and backward refused. ``c2i_families_slice_vs_
   plain``: one REPA step (Baseline_DiT.yaml's trainer, a 1-layer DINOv2 at
   full width) of a 2-block BaselineDiT and a 2 + 1 block PixNerdC2I at
   hidden 1,024, card against CPU: loss, cos_loss, all gradients, those of
   the projection and of the tapped block, and the tower's fp32 features.
   ``baseline_fit``: ``cli fit -c configs_c2i/Baseline_DiT.yaml`` as shipped
   (batch 32 x diffusion_batch_mul 4, no remat, the random tower) for 3
   steps: cos_loss above 1e-4, exactly 24 / 24 / 24 forward-with-lse / dQ /
   dK-dV and 12 fp32 launches a step, s/step, idle share, peak memory, MFU,
   the checkpoint with the projection; then ``cli predict`` of 32 images,
   50 steps, 1,200 forward launches. ``families_fit``: one step each of
   Baseline_DiT_JiT.yaml, Baseline_PixNerd.yaml, DeCo_large.yaml and
   configs_t2i/pretraining_res256.yaml (from a tar shard of PNGs), with
   their launches. The files go under ``build/chip_smoke_c2i_families/``,
   which is deleted.
14. reco: ReCo at full width. ``reco_kernels``: the forward, the forward
   with lse, dQ and dK/dV at the ReCo shapes (D = 64: the InternViT tower's
   257 tokens and the decoder blocks' 272 at the fit batch of 64 rows at
   224 px; 1,025 and 1,040 at 16 rows at 448 px) against their plain
   versions, bit-identical over two runs, timed beside bound, plain
   versions and SDPA. ``reco_slice_vs_plain``: ReCo_large.yaml's model
   (24-layer tower, 6 + 3 decoder blocks, bf16, seeded), one forward and
   one DeCoTrainer loss gradient at batch 2 with the kernels against the
   same with the plain attention on the card (gates from the CPU readings
   of ``--calibrate-reco-slice``), 30 launches of each kernel. ``reco_fit``:
   ``cli fit`` on ReCo_large.yaml as shipped (batch 16 x
   diffusion_batch_mul 4, its WandbLogger node kept) but for the data nodes
   (PixImageNet over 64 seeded PNGs: the card host has no ``datasets``),
   the work directory and 3 steps: finite losses, exactly 30 / 30 / 30
   forward-with-lse / dQ / dK-dV launches a step, s/step, idle share, peak
   memory, MFU, the 6.8 GB checkpoint. ``reco_validate``: ``cli validate``
   from it on 32 seeded PNGs, one batch of 32, 100 Euler steps: exactly
   3,000 forward launches (the condition image goes through the tower at
   every step, as in the JAX model), images/s, PSNR/SSIM/FID from
   ``predict_metrics.json``, 16 original|reconstruction panels.
   ``reco_448_step``: one step of ReCo_large_stage3.yaml at its shipped
   batch at 448 px without a checkpoint: its peak memory, or "out of
   memory" (the JAX model has no remat option). The files go under
   ``build/chip_smoke_reco/``, which is deleted.
15. vae: the VAE-GAN and the DC-AE eval (``configs/vae_*.yaml``,
   ``configs_flow/dcae_decoder_eval.yaml``): InternViT-300M -> the DC-AE
   f32c32 decoder, whose attention runs the bf16 kernels at D = 32.
   ``vae_kernels``: the forward, the forward with lse, dQ and dK/dV at D =
   32 at the 224 px fit shapes (batch 8: 64, 256 and 1,024 tokens), the
   ragged 256 px validate shapes (batch 32 padded to 280 px: 100, 400 and
   1,600) and the 448 px fit shapes (batch 16: 256, 1,024, 4,096), against
   their plain versions (on the first rows of a batch whose fp32 logits
   pass 4 GB), bit-identical over two runs, timed beside bound, plain
   versions and SDPA, with each instantiation's resources.
   ``vae_slice_vs_plain``: vae_training_stage2_224.yaml's model at full
   width (the tower cut to 4 layers, the whole decoder), batch 2, the
   forward and the gradients with the kernels against the plain attention
   on the card (gates from ``--calibrate-vae-slice``). ``vae_fit``: ``cli
   fit`` on that config as shipped but for the data nodes (PixImageNet over
   seeded PNGs) and the work directory, 3 steps: finite metrics, exactly 33
   / 27 / 27 forward-with-lse / dQ / dK-dV launches a step, s/step, idle
   share, peak memory, the 9.0 GB checkpoint's bytes and save time;
   ``vae_step_breakdown``: the fit's step function on its state, steady
   wall time and one step's device time by kind of kernel;
   ``vae_validate_224`` and ``_256``: ``cli validate`` of vae_val_224px.yaml
   and vae_val_256px.yaml from it, one batch of 32 each, 33 forward
   launches, finite PSNR/SSIM/FID; ``vae_disc_start_step``: one more step
   with ``discriminator_start=0`` (the GAN term and the adaptive weight
   live), no checkpoint; ``vae_448_step``: one step of
   vae_training_stage2.yaml at batch 16 and 448 px, no checkpoint, its peak
   memory or "out of memory"; ``dcae_eval``: ``cli validate`` of the DC-AE
   decoder eval on a PNG folder, one batch of 32, 33 forward launches. The
   files go under ``build/chip_smoke_vae/``, which is deleted.
16. uniflow: UniFlow (``configs_flow/uniflow_*.yaml``, 1.09B parameters:
   the InternViT tower and a 4-layer shallow ViT, the gated latent
   projector, a pixel trunk of 6 blocks at width 1,024 and a causal
   semantic trunk of 6 at width 2,048, two flow heads). ``uniflow_kernels``:
   the causal instantiations of the forward, the forward with lse, dQ and
   dK/dV at D = 64 at (16, 256), (16, 64), (2, 1,024) and a ragged (16, 100)
   x 32 heads against their masked plain versions, bit-identical over two
   runs, timed beside bound (half the operations, or the bytes), plain
   versions and SDPA's ``is_causal``, with their resources.
   ``uniflow_slice_vs_plain``: the full widths with the InternViT cut to 2
   layers, the shallow ViT to 1 and each trunk to 1 block, one
   ``forward_loss`` and its gradients at batch 2, the card's kernels against
   the CPU's plain versions (gates from ``--calibrate-uniflow-slice``).
   ``uniflow_fit``: ``cli fit`` on uniflow_internvit_2b_base.yaml as
   shipped but for the data nodes (PixImageNet over seeded PNGs) and the
   work directory, 3 steps at batch 16 and 224 px: finite loss terms,
   exactly 34 + 6 causal launches of each training kernel a step, s/step,
   idle share, MFU, peak memory, the checkpoint's bytes and save time (into
   host memory, see ``phase_uniflow``); ``uniflow_validate``: ``cli
   validate`` from it, one batch of 32 at 256 px: 34 forward launches,
   finite PSNR/SSIM/FID; ``uniflow_semantic``: a semantic reconstruction
   (the causal forward); ``uniflow_448`` and ``uniflow_sem``: one step each
   of the 448 px stage-2 config (EMA, frozen encoder) and the semantic-AE
   config from a PixWebDataset node over a PNG tar shard. The files go under
   ``build/chip_smoke_uniflow/``, which is deleted.
17. kernels: one JSON line listing every kernel with its launches on its
   path (sampling for the forward, training for the others) and on the CLI
   paths, error, times, bound, library time and the library call's
   backend, for the attention kernels the same at N = 1024, for the
   forward its t2i serving launches and its times at the D = 64 t2i
   shapes, for the training kernels their t2i and Baseline-DiT fit
   launches and times, the fp32 forward with its launches in the
   Baseline-DiT fit and its times at the tower's shapes, and for the bf16
   attention kernels their ReCo fit, validate and 448 px launches and their
   times at the ReCo shapes, and their VAE-GAN launches (fit, validate,
   DC-AE eval), times at the D = 32 shapes and D = 32 resources, and their
   UniFlow launches; and the four causal instantiations with their UniFlow
   launches, times at the causal shapes and resources.

``python3 chip_smoke.py --calibrate-train-slice`` (and ``--calibrate-t2i-slice``,
``--calibrate-t2i-train-slice``, ``--calibrate-c2i-families-slice``,
``--calibrate-reco-slice``, ``--calibrate-vae-slice``,
``--calibrate-uniflow-slice``) prints, on the CPU, the readings between
which the train-slice (t2i slice, t2i train slice, c2i families slice, ReCo
slice, VAE slice, UniFlow slice) gates sit, and no result.

Every phase prints JSON lines; a failed phase raises and the script exits
non-zero without the last line. The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import functools
import json
import re
import sys
import time

import numpy as np

# bf16 kernel vs plain version: both round the output to bf16 (2^-8 relative
# on values of order 1) and round P to bf16 against different maxima (running
# vs final); 3e-2 is the JAX package's bf16 attention tolerance.
ATTN_ATOL = 3e-2
# The causal holds take it in units of max(1, |plain|): a causal row's first
# queries average one to a few values, so outputs reach |o| ~ 4.5 (randn
# values), where one bf16 step is 2^-5 = 0.031 and the two sides' output
# roundings alone can differ by it (the first card run of phase 16 read
# exactly 0.03125 at the ragged shape).
def _attn_err(out, ref, causal: bool = False) -> float:
    diff = (out.float() - ref.float()).abs()
    return (diff / ref.float().abs().clamp(min=1.0) if causal else diff).max().item()


# The 8-step slice, card vs CPU, both bf16: GEMMs and softmax round at other
# points on each side. On the CPU this config's bf16 images differ from fp32
# by rel L2 0.009, and zeroing the trunk's attention moves them by 0.103;
# 0.03 sits between, so it passes rounding and fails a wrong attention.
SLICE_REL_L2 = 0.03
# Training kernels vs plain versions: lse is an fp32 sum of exact bf16
# products in another order (1e-3); the backward kernels round P and dS to
# bf16 before their products, as the TPU kernels do, where the plain version
# keeps fp32, so their max error is held to 2e-2 of the largest plain value;
# delta is an fp32 sum of D exact products of bf16 values in another order
# (1e-4 of the largest plain value); the frequency MSE is an fp32 sum of ~6M
# terms in another order (rtol 1e-4).
LSE_ATOL = 1e-3
BWD_REL = 2e-2
DELTA_REL = 1e-4
FREQ_RTOL = 1e-4
# The one-step train slice, card vs CPU, both bf16 compute. On the CPU
# (--calibrate-train-slice) bf16 differs from fp32 by grad rel L2 0.0030 and
# update rel L2 0.131; zeroing the attention backward moves them by 0.053
# and 0.755. The gates sit between; the loss, which the attention backward
# cannot move, is held to 10x its bf16-vs-fp32 reading of 2.2e-4.
TRAIN_SLICE_GRAD_REL_L2 = 0.015
TRAIN_SLICE_UPDATE_REL_L2 = 0.4
TRAIN_SLICE_LOSS_REL = 2e-3
ATTN_BWD_KINDS = ("flash_bwd_dq_kernel", "flash_bwd_dkv_kernel")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def cuda_ms(fn, iters: int, flush=None) -> float:
    """Median device milliseconds of ``fn()``, each call timed by CUDA events,
    with L2 flushed before each call when ``flush`` is given: by writing it
    if it is a tensor, by calling it if it is a function."""
    import torch

    for _ in range(3):
        fn()
    times = []
    for _ in range(iters):
        if callable(flush):
            flush()
        elif flush is not None:
            flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        times.append((start, end))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in times]))


def phase_build():
    from deco_tpu_torch._device import card_info
    from deco_tpu_torch.ops import _build

    t0 = time.perf_counter()
    seconds = _build.build()
    for name in seconds:
        log = (_build.BUILD_DIR / f"{name}.log").read_text()
        print(f"[{name}]\n{log}", file=sys.stderr)
    card = card_info()
    print(card, flush=True)
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "per_source": seconds,
          "nvcc_flags": " ".join(_build.NVCC_FLAGS), "card": card})
    return card


def phase_kernel(card: str):
    import torch

    from deco_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain

    gen = torch.Generator(device="cuda").manual_seed(0)

    def qkv(b, nq, nkv, h, d):
        shapes = ((b, nq, h, d), (b, nkv, h, d), (b, nkv, h, d))
        return [torch.randn(s, generator=gen, device="cuda").to(torch.bfloat16) for s in shapes]

    shapes = {  # (B, Nq, Nkv, H, D)
        "main": (16, 256, 256, 16, 72),  # DeCo-XL/16 256 px, CFG at batch 8: B*H = 256
        "ragged": (2, 200, 200, 16, 72),
        "cross": (2, 256, 333, 16, 72),
        "d64": (4, 256, 256, 16, 64),
        "d128": (2, 256, 256, 8, 128),
        "long": (1, 4096, 4096, 16, 72),  # stands for the JAX streaming variant
        "s512": (12, 1024, 1024, 16, 72),  # 512 px, CFG at batch 6: B*H = 192, N = 1024
    }
    errs = {}
    for name, shape in shapes.items():
        q, k, v = qkv(*shape)
        out, again = flash_attention(q, k, v), flash_attention(q, k, v)
        torch.cuda.synchronize()
        ref = flash_attention_plain(q, k, v)
        check(out.shape == ref.shape and bool(torch.isfinite(out).all()), f"{name}: bad output")
        errs[name] = (out.float() - ref.float()).abs().max().item()
        emit({"phase": "kernel", "shape": name, "b_nq_nkv_h_d": shape,
              "max_abs_err": errs[name], "atol": ATTN_ATOL,
              "bit_identical": torch.equal(out, again)})
        check(errs[name] < ATTN_ATOL, f"flash attention {name} error {errs[name]} >= {ATTN_ATOL}")
        check(torch.equal(out, again), f"flash attention {name} differs between two runs")

    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")  # > the 50 MB L2
    timings = {}
    for name, iters in (("main", 50), ("s512", 20)):
        b, nq, nkv, h, d = shapes[name]
        q, k, v = qkv(*shapes[name])
        nbytes = 2 * (q.numel() + k.numel() + v.numel() + q.numel())
        timings[name] = {
            "ms": cuda_ms(lambda: flash_attention(q, k, v), iters, flush),
            "plain_ms": cuda_ms(lambda: flash_attention_plain(q, k, v), iters // 2, flush),
            **sdpa_forward_yardsticks(q, k, v, d ** -0.5, False, flush, iters),
            **_bound(card, nbytes, 4 * b * h * nq * nkv * d),
            "l2": "flushed before each call", "card": card}
        emit({"phase": "kernel", "shape": name, "timing": timings[name]})
    return {"max_abs_err": errs["main"], **timings["main"], "n1024": timings["s512"]}


SDPA_BACKENDS = ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION")


def sdpa_forward_yardsticks(q, k, v, scale: float, with_lse: bool, flush, iters: int,
                            causal: bool = False) -> dict:
    """Each SDPA backend's forward on the (B, N, H, D) operands, pinned with
    ``sdpa_kernel``: ``F.scaled_dot_product_attention`` without lse, else
    the backend's own aten entry with its logsumexp, with ``is_causal`` when
    ``causal``. Returns every backend's ms or the reason it refused, and the
    fastest as ``library_ms`` with its name in ``library_backend``. A
    yardstick only: the port never calls SDPA."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))  # SDPA's (B, H, N, D) views
    aten = torch.ops.aten
    with_lse_calls = {
        "FLASH_ATTENTION": lambda: aten._scaled_dot_product_flash_attention(
            qt, kt, vt, 0.0, causal, False, scale=scale),
        "EFFICIENT_ATTENTION": lambda: aten._scaled_dot_product_efficient_attention(
            qt, kt, vt, None, True, 0.0, causal, scale=scale),
        "CUDNN_ATTENTION": lambda: aten._scaled_dot_product_cudnn_attention(
            qt, kt, vt, None, True, 0.0, causal, False, scale=scale),
    }
    per_backend = {}
    for name in SDPA_BACKENDS:
        fn = with_lse_calls[name] if with_lse else (
            lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=scale, is_causal=causal))
        try:
            with sdpa_kernel(getattr(SDPBackend, name)):
                per_backend[name] = cuda_ms(fn, iters, flush)
        except RuntimeError as err:
            per_backend[name] = "refused: " + " ".join(str(err).split())[:200]
    timed = {n: ms for n, ms in per_backend.items() if isinstance(ms, float)}
    best = min(timed, key=timed.get) if timed else None
    return {"library_ms": timed.get(best), "library_backend": best,
            "sdpa_backends_ms": per_backend,
            "sdpa_entry": "aten backend entry with lse" if with_lse else "F.sdpa, no grad"}


def sdpa_backward_yardsticks(q, k, v, do, scale: float, flush, iters: int,
                             causal: bool = False) -> dict:
    """Each SDPA backend's backward kernel on the (B, N, H, D) operands: its
    aten backward entry (dQ, dK and dV together) on the outputs of its own
    forward, run once beforehand, so that the time is the backend's kernels
    and not autograd's. Returns every backend's ms or the reason it refused,
    and the fastest as ``sdpa_backward_ms`` with its name in
    ``sdpa_backward_backend``. A yardstick only: the port never calls SDPA."""
    import torch

    qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))  # SDPA's (B, H, N, D) views
    aten = torch.ops.aten

    def flash():
        out, lse, cq, ck, mq, mk, seed, offset, _ = aten._scaled_dot_product_flash_attention(
            qt, kt, vt, 0.0, causal, False, scale=scale)
        return lambda: aten._scaled_dot_product_flash_attention_backward(
            dot, qt, kt, vt, out, lse, cq, ck, mq, mk, 0.0, causal, seed, offset, scale=scale)

    def efficient():
        out, lse, seed, offset = aten._scaled_dot_product_efficient_attention(
            qt, kt, vt, None, True, 0.0, causal, scale=scale)
        return lambda: aten._scaled_dot_product_efficient_attention_backward(
            dot, qt, kt, vt, None, out, lse, seed, offset, 0.0, [True, True, True, False],
            causal, scale=scale)

    def cudnn():
        out, lse, cq, ck, mq, mk, seed, offset, _ = aten._scaled_dot_product_cudnn_attention(
            qt, kt, vt, None, True, 0.0, causal, False, scale=scale)
        return lambda: aten._scaled_dot_product_cudnn_attention_backward(
            dot, qt, kt, vt, out, lse, seed, offset, None, cq, ck, mq, mk, 0.0, causal,
            scale=scale)

    per_backend = {}
    for name, backward in (("FLASH_ATTENTION", flash), ("EFFICIENT_ATTENTION", efficient),
                           ("CUDNN_ATTENTION", cudnn)):
        try:
            per_backend[name] = cuda_ms(backward(), iters, flush)
        except (RuntimeError, TypeError) as err:
            per_backend[name] = "refused: " + " ".join(str(err).split())[:200]
    timed = {n: ms for n, ms in per_backend.items() if isinstance(ms, float)}
    best = min(timed, key=timed.get) if timed else None
    return {"sdpa_backward_ms": timed.get(best), "sdpa_backward_backend": best,
            "sdpa_backward_backends_ms": per_backend,
            "sdpa_backward_entry": "aten backend backward entry"}


# Kernels the resource lines report, as their names appear in ptxas's log.
_KERNEL_NAME = re.compile(
    r"(?<=\d)(flash_fwd(?:_f32)?_kernel|flash_bwd_d(?:q|kv)_kernel|freq_mse(?:_[a-z]+)?_kernel)"
    r"(?:ILi(\d+)E((?:Lb\dE)*))?")


def kernel_resources(build_dir, source: str, runtime=None) -> list:
    """One row per kernel instantiation in ``source``'s build log: ptxas's
    registers, spills and static shared memory, and, where ``runtime`` is
    given (a ``*_kernel_info`` function of the ops), the CUDA runtime's
    dynamic shared memory and resident CTAs per SM."""
    from deco_tpu_torch.ops import _build

    report = _build.ptxas_report((build_dir / f"{source}.log").read_text())
    rows = []
    for mangled, ptxas in report.items():
        m = _KERNEL_NAME.search(mangled)
        if m is None:
            continue
        # the bool template flags: <D, LSE, CAUSAL> forward, <D, CAUSAL> backward
        name, d, flags = m.group(1), m.group(2), re.findall(r"Lb(\d)E", m.group(3) or "")
        # (an older checkout's forward has <D, LSE> and its backward <D>)
        if name == "flash_fwd_kernel":
            lse, causal = flags[0] == "1", flags[1:] == ["1"]
        else:
            lse, causal = False, flags[:1] == ["1"]
        key = name + ("_lse" if lse else "") + ("_causal" if causal else "")
        info = None
        if runtime is not None:
            info = (runtime(int(d)) if d else runtime())[key]
        rows.append({"kernel": key + (f"<{d}>" if d else ""), "ptxas": ptxas, "runtime": info})
    return sorted(rows, key=lambda r: r["kernel"])


def _bound(card: str, nbytes: float, flops: float, fp32: bool = False) -> dict:
    from deco_tpu_torch.utils.flops import card_fp32_peak, card_peaks

    peak_flops, peak_bytes = card_peaks(card)
    if fp32:
        peak_flops = card_fp32_peak(card)
    bound = {"bytes": nbytes / peak_bytes * 1e3, "operations": flops / peak_flops * 1e3}
    bound_by = max(bound, key=bound.get)
    return {"bound_ms": bound[bound_by], "bound_by": bound_by, "bytes": nbytes, "flops": flops}


def _max_rel(out, ref) -> float:
    return ((out.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


def _backward(q, k, v, o, lse, do, scale, causal: bool = False):
    """(dQ, delta, dK, dV) from the two backward kernels."""
    from deco_tpu_torch.ops import flash_attention as fa

    dq, delta = fa.flash_attention_bwd_dq(q, k, v, o, lse, do, scale, causal)
    return (dq, delta, *fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale, causal))


def _attention_timings(card: str, operands, flush, iters: int, plain_b=None,
                       causal: bool = False) -> dict:
    """Times of the forward with lse, dQ (with delta) and dK/dV at one
    shape, beside their plain versions, bounds and library yardsticks: the
    fastest SDPA backend's forward with logsumexp, and the fastest SDPA
    backend's backward kernels (dQ, dK and dV together, through its aten
    backward entry) against the whole backward (dQ, then dK/dV). ``plain_b``
    times the plain versions on the first ``plain_b`` rows of the batch
    (their fp32 logits of a whole large batch do not fit in the card's
    memory) and says so in each row. ``causal`` takes the causal
    instantiations, their plain versions and SDPA's ``is_causal``, and
    halves the operations of the bound (the kernels visit the tiles up to
    the diagonal)."""
    from deco_tpu_torch.ops import flash_attention as fa

    q, k, v, do = operands
    b, nq, h, d = q.shape
    nkv = k.shape[1]
    scale = d ** -0.5
    o, lse = fa.flash_attention_fwd_lse(q, k, v, scale, causal)
    _, delta = fa.flash_attention_bwd_dq(q, k, v, o, lse, do, scale, causal)
    rows, op = b * h * nq, 2 * q.numel()  # rows of lse/delta; bytes of one bf16 operand
    work = b * h * nq * nkv * d / (2 if causal else 1)
    plain_iters = max(iters // 5, 3)
    pq, pk, pv, pdo, po, plse, pdelta = (x[:plain_b] for x in (q, k, v, do, o, lse, delta))
    out = {"fwd_lse": {
        "ms": cuda_ms(lambda: fa.flash_attention_fwd_lse(q, k, v, scale, causal), iters, flush),
        "plain_ms": cuda_ms(lambda: fa.flash_attention_fwd_lse_plain(pq, pk, pv, scale, causal),
                            plain_iters, flush),
        **sdpa_forward_yardsticks(q, k, v, scale, True, flush, iters, causal),
        **_bound(card, 4 * op + 4 * rows, 4 * work)}}
    # dQ reads q, k, v, o, do and lse and writes dq and delta; dK/dV reads
    # q, k, v, do, lse and delta and writes dk and dv
    for name, kernel, plain, args, plain_args, nbytes, flops in (
            ("bwd_dq", fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dq_plain,
             (q, k, v, o, lse, do, scale, causal), (pq, pk, pv, po, plse, pdo, scale, causal),
             6 * op + 8 * rows, 6 * work),
            ("bwd_dkv", fa.flash_attention_bwd_dkv, fa.flash_attention_bwd_dkv_plain,
             (q, k, v, do, lse, delta, scale, causal), (pq, pk, pv, pdo, plse, pdelta, scale,
                                                        causal),
             6 * op + 8 * rows, 8 * work)):
        out[name] = {"ms": cuda_ms(lambda: kernel(*args), iters, flush),
                     "plain_ms": cuda_ms(lambda: plain(*plain_args), plain_iters, flush),
                     "library_ms": None,  # no one PyTorch call computes dQ (or dK, dV) alone
                     **_bound(card, nbytes, flops)}
    whole_ms = cuda_ms(lambda: fa.flash_attention_bwd(q, k, v, o, lse, do, scale, causal), iters,
                       flush)
    sdpa = sdpa_backward_yardsticks(q, k, v, do, scale, flush, iters, causal)
    for name in ("bwd_dq", "bwd_dkv"):
        out[name].update(whole_backward_ms=whole_ms, **sdpa)
    if plain_b is not None:
        for row in out.values():
            row["plain_b"] = plain_b
    return out


def kernel_resource_lines(card: str) -> None:
    """One line each for the forward, the backward and the frequency MSE:
    every kernel instantiation's registers, spills and static shared memory
    from the build log (ptxas), with its dynamic shared memory and resident
    CTAs per SM from the CUDA runtime."""
    from deco_tpu_torch.ops import _build, block_dct
    from deco_tpu_torch.ops import flash_attention as fa

    for key, source, runtime, count in (
            ("forward_resources", "flash_attention_fwd", fa.forward_kernel_info,
             2 * len(fa.SUPPORTED_HEAD_DIMS) + len(fa.F32_HEAD_DIMS)
             + 2 * len(fa.CAUSAL_HEAD_DIMS)),
            ("backward_resources", "flash_attention_bwd", fa.backward_kernel_info,
             2 * len(fa.SUPPORTED_HEAD_DIMS) + 2 * len(fa.CAUSAL_HEAD_DIMS)),
            ("freq_mse_resources", "freq_mse", block_dct.kernel_info, 1)):
        rows = kernel_resources(_build.BUILD_DIR, source, runtime)
        check(len(rows) == count, f"{source} build log lists {rows}")
        emit({"phase": "kernels_train", key: rows, "card": card})


def attention_operands(gen, b, nq, nkv, h, d) -> list:
    """Seeded bf16 (q, k, v, dO) on the card for a (B, Nq, Nkv, H, D) shape."""
    import torch

    shapes = ((b, nq, h, d), (b, nkv, h, d), (b, nkv, h, d), (b, nq, h, d))
    return [torch.randn(s, generator=gen, device="cuda").to(torch.bfloat16) for s in shapes]


def hold_attention_training(phase: str, name: str, shape, operands,
                            causal: bool = False) -> dict:
    """The forward with lse, dQ (with delta) and dK/dV at one shape against
    their plain versions (``causal``: the causal instantiations against the
    masked plain versions), each bit-identical over two runs; emits and
    checks the row, and returns it with the worst error of each kernel."""
    import torch

    from deco_tpu_torch.ops import flash_attention as fa

    q, k, v, do = operands
    scale = shape[-1] ** -0.5
    o, lse = fa.flash_attention_fwd_lse(q, k, v, scale, causal)
    o2, lse2 = fa.flash_attention_fwd_lse(q, k, v, scale, causal)
    dq, delta, dk, dv = _backward(q, k, v, o, lse, do, scale, causal)
    again = _backward(q, k, v, o, lse, do, scale, causal)
    torch.cuda.synchronize()
    fwd_bit_identical = torch.equal(o, o2) and torch.equal(lse, lse2)
    bit_identical = all(torch.equal(a, b) for a, b in zip((dq, delta, dk, dv), again))
    o_ref, lse_ref = fa.flash_attention_fwd_lse_plain(q, k, v, scale, causal)
    dq_ref, delta_ref = fa.flash_attention_bwd_dq_plain(q, k, v, o, lse, do, scale, causal)
    dk_ref, dv_ref = fa.flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta, scale, causal)
    for x in (o, lse, dq, delta, dk, dv):
        check(bool(torch.isfinite(x).all()), f"{name}: a training kernel output is not finite")
    row = {"o_max_abs_err": (o.float() - o_ref.float()).abs().max().item(),
           "o_max_err": _attn_err(o, o_ref, causal),
           "lse_max_abs_err": (lse - lse_ref).abs().max().item(),
           "delta_max_rel_err": _max_rel(delta, delta_ref)}
    for key, out, ref in (("dq", dq, dq_ref), ("dk", dk, dk_ref), ("dv", dv, dv_ref)):
        row[key + "_max_abs_err"] = (out.float() - ref.float()).abs().max().item()
        row[key + "_max_rel_err"] = _max_rel(out, ref)
    emit({"phase": phase, "shape": name, "b_nq_nkv_h_d": shape, **row, "causal": causal,
          "forward_bit_identical": fwd_bit_identical,
          "backward_bit_identical": bit_identical, "atol": ATTN_ATOL,
          "lse_atol": LSE_ATOL, "bwd_rel": BWD_REL, "delta_rel": DELTA_REL})
    check(row["o_max_err"] < ATTN_ATOL and row["lse_max_abs_err"] < LSE_ATOL,
          f"forward with lse {name}: {row}")
    check(row["delta_max_rel_err"] < DELTA_REL, f"delta {name}: {row}")
    check(max(row["dq_max_rel_err"], row["dk_max_rel_err"], row["dv_max_rel_err"]) < BWD_REL,
          f"attention backward {name}: {row}")
    check(fwd_bit_identical, f"forward with lse {name} differs between two runs")
    check(bit_identical, f"attention backward {name} differs between two runs")
    row["errs"] = {"fwd_lse": row["o_max_abs_err"], "bwd_dq": row["dq_max_abs_err"],
                   "bwd_dkv": max(row["dk_max_abs_err"], row["dv_max_abs_err"])}
    return row


def phase_kernels_train(card: str):
    """Forward with lse, dQ, dK/dV and the frequency MSE against their plain
    versions, then their times at the training shape and at N = 4096."""
    import torch

    from deco_tpu_torch.ops import block_dct
    from deco_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(3)
    operands = functools.partial(attention_operands, gen)
    shapes = {  # (B, Nq, Nkv, H, D)
        "train": (32, 256, 256, 16, 72),  # DeCo-XL/16 256 px at batch 32: B*H = 512
        "ragged": (2, 200, 200, 16, 72),
        "cross": (2, 256, 333, 16, 72),
        "d64": (4, 256, 256, 16, 64),
        "d128": (2, 256, 256, 8, 128),
        "long": (1, 4096, 4096, 16, 72),  # stands for the JAX streaming variants
        # 512 px training, microbatch 16 (batch 16 x accumulation 2 per step): B*H = 256
        "t512": (16, 1024, 1024, 16, 72),
    }
    kernel_resource_lines(card)
    errs = {"fwd_lse": 0.0, "bwd_dq": 0.0, "bwd_dkv": 0.0}
    for name, shape in shapes.items():
        row = hold_attention_training("kernels_train", name, shape, operands(*shape))
        for key, value in row["errs"].items():
            errs[key] = max(errs[key], value)

    w = block_dct.build_freq_weight()
    errs["freq_mse"] = 0.0
    for shape in ((32, 256, 256, 3), (2, 16, 2048, 3), (3, 24, 520, 3)):
        diff = torch.randn(shape, generator=gen, device="cuda")
        first, second = block_dct.freq_mse(diff, w), block_dct.freq_mse(diff, w)
        ref = block_dct.frequency_weighted_mse_plain(diff, w)
        rel = abs(first.item() - ref.item()) / abs(ref.item())
        emit({"phase": "kernels_train", "shape": list(shape), "freq_mse": first.item(),
              "plain": ref.item(), "rel_err": rel, "rtol": FREQ_RTOL,
              "bit_identical": bool(torch.equal(first, second))})
        check(torch.equal(first, second), f"freq_mse {shape} differs between two runs")
        check(rel < FREQ_RTOL, f"freq_mse {shape} rel err {rel} >= {FREQ_RTOL}")
        errs["freq_mse"] = max(errs["freq_mse"], abs(first.item() - ref.item()))

    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")  # > the 50 MB L2
    timings = {}
    for name, iters in (("train", 50), ("long", 10), ("t512", 20)):  # long: the streaming rows
        suffix = {"train": "", "long": "_long", "t512": "_512"}[name]
        for kernel, timing in _attention_timings(card, operands(*shapes[name]), flush,
                                                 iters).items():
            timings[kernel + suffix] = timing

    q, k, v, _ = operands(*shapes["long"])  # the forward without lse at N = 4096
    b, nq, nkv, h, d = shapes["long"]
    timings["fwd_long"] = {
        "ms": cuda_ms(lambda: fa.flash_attention(q, k, v), 10, flush),
        "plain_ms": cuda_ms(lambda: fa.flash_attention_plain(q, k, v), 5, flush),
        **sdpa_forward_yardsticks(q, k, v, d ** -0.5, False, flush, 10),
        **_bound(card, 4 * 2 * q.numel(), 4 * b * h * nq * nkv * d)}
    del q, k, v

    diff = torch.randn(32, 256, 256, 3, generator=gen, device="cuda")
    # per element: YCbCr 5, separable DCT 32, weight, square and sum 3 fp32 operations
    timings["freq_mse"] = {
        "ms": cuda_ms(lambda: block_dct.freq_mse(diff, w), 50, flush),
        "plain_ms": cuda_ms(lambda: block_dct.frequency_weighted_mse_plain(diff, w), 20, flush),
        "library_ms": None,  # no single PyTorch call computes this function
        **_bound(card, 4 * diff.numel() + 4, 40 * diff.numel(), fp32=True)}
    for name, timing in timings.items():
        emit({"phase": "kernels_train", "timing": name, **timing,
              "l2": "flushed before each call", "card": card})
    return errs, timings


def phase_model():
    import torch

    from deco_tpu_torch.ops.flash_attention import flash_attention
    from deco_tpu_torch.sample import build_model

    t0 = time.perf_counter()
    model = build_model("deco_xl_256", device="cuda", seed=0)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(2, 256, 256, 3, generator=gen, device="cuda")
    t = torch.tensor([0.3, 0.7], device="cuda")
    y = torch.tensor([1, 1000], device="cuda")
    before = flash_attention.launches
    with torch.no_grad():
        out = model(x, t, y)
    torch.cuda.synchronize()
    launches = flash_attention.launches - before
    params = sum(p.numel() for p in model.parameters())
    emit({"phase": "model", "params": params, "build_and_init_s": build_s,
          "out_shape": list(out.shape), "finite": bool(torch.isfinite(out).all()),
          "out_std": out.std().item(), "flash_launches": launches})
    check(tuple(out.shape) == (2, 256, 256, 3), "model output shape")
    check(bool(torch.isfinite(out).all()), "model output not finite")
    check(launches == len(model.blocks) == 28, f"{launches} attention launches, expected 28")
    return model


def phase_slice():
    import torch

    from deco_tpu_torch.ops.flash_attention import flash_attention
    from deco_tpu_torch.sample import build_model, build_sampler, generate

    depth = dict(num_cond_blocks=4, num_blocks=7)
    steps = 8
    sampler = build_sampler("deco_xl_256", steps)
    results = {}
    for device in ("cuda", "cpu"):
        model = build_model("deco_xl_256", device=device, seed=1, **depth)
        before = flash_attention.launches
        t0 = time.perf_counter()
        results[device] = generate(model, sampler, 2, 2, image_size=256, device=device)
        results[device + "_s"] = time.perf_counter() - t0
        results[device + "_launches"] = flash_attention.launches - before
    gpu, cpu = results["cuda"], results["cpu"]
    rel_l2 = ((gpu - cpu).norm() / cpu.norm()).item()
    emit({"phase": "slice_vs_plain", "trunk_blocks": 4, "decoder_blocks": 3, "steps": steps,
          "batch": 2, "max_abs_err": (gpu - cpu).abs().max().item(),
          "mean_abs_err": (gpu - cpu).abs().mean().item(), "rel_l2": rel_l2,
          "rel_l2_limit": SLICE_REL_L2, "cuda_s": results["cuda_s"], "cpu_s": results["cpu_s"],
          "cuda_flash_launches": results["cuda_launches"],
          "cpu_flash_launches": results["cpu_launches"]})
    check(bool(torch.isfinite(gpu).all()), "slice images not finite")
    check(results["cuda_launches"] == 4 * steps, "slice did not run the kernel every step")
    check(results["cpu_launches"] == 0, "the CPU slice launched a kernel")
    check(rel_l2 < SLICE_REL_L2, f"slice card vs CPU rel L2 {rel_l2} >= {SLICE_REL_L2}")


TRAIN_SLICE = dict(num_cond_blocks=4, num_blocks=7)  # full width, cut depth


def train_slice_step(device: str, dtype=None, zero_attention_backward: bool = False):
    """One DeCo_XL_freq.yaml training step of the cut-depth model at batch 2:
    (loss, flat gradient, flat parameter update), on the CPU as fp32 tensors.

    Weights, batch and draws come from fixed seeds, so every device and
    dtype starts from the same numbers. ``zero_attention_backward`` makes
    the attention backward return zeros (the reading that sets the gate).
    """
    import torch

    from deco_tpu_torch import fit
    from deco_tpu_torch.ops import flash_attention as fa

    dtype = dtype or torch.bfloat16
    state, _, step = fit.build("deco_xl_256", device=device, seed=1, dtype=dtype, **TRAIN_SLICE)
    before = torch.cat([p.detach().reshape(-1).cpu() for p in state.model.parameters()])
    batch = fit.synthetic_batches(1, 2, 256, 1000, seed=2, device=device)[0]
    rng = np.random.default_rng(3)
    draws = dict(drop_u=np.array([0.9, 0.1], np.float32),  # one label dropped
                 t_normal=rng.standard_normal(2).astype(np.float32),
                 t_uniform=rng.uniform(size=2).astype(np.float32),
                 mix_u=np.array([0.5, 0.95], np.float32),  # both t branches
                 noise=rng.standard_normal((2, 256, 256, 3)).astype(np.float32))
    saved = fa.flash_attention_bwd
    if zero_attention_backward:
        fa.flash_attention_bwd = lambda q, k, v, *_: tuple(map(torch.zeros_like, (q, k, v)))
    try:
        metrics = step(state, batch, draws=[draws])
    finally:
        fa.flash_attention_bwd = saved
    params = list(state.model.parameters())
    grads = torch.cat([p.grad.reshape(-1).cpu() for p in params])
    after = torch.cat([p.detach().reshape(-1).cpu() for p in params])
    return float(metrics["loss"]), grads, after - before


def _rel_l2(a, b) -> float:
    return ((a - b).norm() / b.norm()).item()


def calibrate_train_slice() -> None:
    """The two CPU readings between which TRAIN_SLICE_GATE sits."""
    import torch

    loss32, g32, u32 = train_slice_step("cpu", torch.float32)
    loss16, g16, u16 = train_slice_step("cpu")
    loss0, g0, u0 = train_slice_step("cpu", zero_attention_backward=True)
    emit({"phase": "calibrate_train_slice",
          "bf16_vs_fp32": {"loss_rel": abs(loss16 - loss32) / abs(loss32),
                           "grad_rel_l2": _rel_l2(g16, g32), "update_rel_l2": _rel_l2(u16, u32)},
          "zero_attention_backward_vs_bf16": {
              "loss_rel": abs(loss0 - loss16) / abs(loss16),
              "grad_rel_l2": _rel_l2(g0, g16), "update_rel_l2": _rel_l2(u0, u16)}})


def phase_train_slice():
    from deco_tpu_torch.ops import block_dct
    from deco_tpu_torch.ops import flash_attention as fa

    kernels = (fa.flash_attention_fwd_lse, fa.flash_attention_bwd_dq,
               fa.flash_attention_bwd_dkv, block_dct.freq_mse)
    results = {}
    for device in ("cuda", "cpu"):
        before = [f.launches for f in kernels]
        t0 = time.perf_counter()
        results[device] = train_slice_step(device)
        results[device + "_s"] = time.perf_counter() - t0
        results[device + "_launches"] = [f.launches - n for f, n in zip(kernels, before)]
    (loss, grads, update), (loss_ref, grads_ref, update_ref) = results["cuda"], results["cpu"]
    row = {"loss_rel": abs(loss - loss_ref) / abs(loss_ref),
           "grad_rel_l2": _rel_l2(grads, grads_ref), "update_rel_l2": _rel_l2(update, update_ref)}
    emit({"phase": "train_slice_vs_plain", **TRAIN_SLICE, "batch": 2, "loss": loss,
          "loss_cpu": loss_ref, **row, "loss_rel_limit": TRAIN_SLICE_LOSS_REL,
          "grad_rel_l2_limit": TRAIN_SLICE_GRAD_REL_L2,
          "update_rel_l2_limit": TRAIN_SLICE_UPDATE_REL_L2,
          "cuda_launches_fwd_lse_dq_dkv_freq": results["cuda_launches"],
          "cpu_launches": results["cpu_launches"], "cuda_s": results["cuda_s"],
          "cpu_s": results["cpu_s"]})
    check(all(np.isfinite([loss, loss_ref])), "train slice loss not finite")
    check(results["cuda_launches"] == [8, 4, 4, 1],
          f"train slice launches {results['cuda_launches']}, expected [8, 4, 4, 1]")
    check(results["cpu_launches"] == [0, 0, 0, 0], "the CPU train slice launched a kernel")
    check(row["loss_rel"] < TRAIN_SLICE_LOSS_REL, f"train slice loss {row}")
    check(row["grad_rel_l2"] < TRAIN_SLICE_GRAD_REL_L2, f"train slice gradients {row}")
    check(row["update_rel_l2"] < TRAIN_SLICE_UPDATE_REL_L2, f"train slice update {row}")


def phase_train(card: str):
    """The training main path at full width through ``deco_tpu_torch.fit``."""
    import torch

    from deco_tpu_torch import fit
    from deco_tpu_torch.ops import block_dct
    from deco_tpu_torch.ops import flash_attention as fa
    from deco_tpu_torch.utils.flops import card_peaks, deco_c2i_flops, train_flops_per_image

    batch, warmup, steps = 32, 2, 5
    t0 = time.perf_counter()
    state, _, step = fit.build("deco_xl_256", device="cuda", seed=0)  # freq loss, full remat
    batches = fit.synthetic_batches(4, batch, 256, 1000, seed=0, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    build_s = time.perf_counter() - t0
    check(len(state.model.blocks) == 28 and state.model.trunk_checkpoint, "not the XL remat config")
    fit.train(state, step, batches, warmup, gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels = {"fwd_lse": fa.flash_attention_fwd_lse, "bwd_dq": fa.flash_attention_bwd_dq,
               "bwd_dkv": fa.flash_attention_bwd_dkv, "freq_mse": block_dct.freq_mse,
               "fwd": fa.flash_attention}
    for f in kernels.values():
        f.launches = 0
    t0 = time.perf_counter()
    metrics = fit.train(state, step, batches, steps, gen)
    losses = [float(m["loss"]) for m in metrics]  # waits for the device
    seconds = time.perf_counter() - t0
    launches = {name: f.launches for name, f in kernels.items()}
    peak_mem = torch.cuda.max_memory_allocated()
    grad_norms = [float(m["grad_norm"]) for m in metrics]

    # one more step: the parameters move and the EMA follows e*d + p*(1-d)
    params = list(state.model.parameters())
    p0 = [p.detach().clone() for p in params]
    e0 = [e.clone() for e in state.ema_params]
    fit.train(state, step, batches, 1, gen)
    decay = fit.PRESETS["deco_xl_256"]["ema_decay"]
    moved = max((p.detach() - a).abs().max().item() for p, a in zip(params, p0))
    ema_moved = max((e - a).abs().max().item() for e, a in zip(state.ema_params, e0))
    ema_ulps, num, den = 0.0, 0.0, 0.0
    for e, a, p in zip(state.ema_params, e0, params):
        # each element within 2 fp32 ulps of e*d + p*(1-d) taken in fp64, the
        # ulp taken at the larger of |e| before and after (e*d rounds at |e|) ...
        ref = a.double() * decay + p.detach().double() * (1 - decay)
        ulp = torch.maximum(a.abs(), e.abs()).double() * 2.0**-23 + 1e-45
        ema_ulps = max(ema_ulps, ((e.double() - ref).abs() / ulp).max().item())
        # ... and, where |e| is small enough for fp32 to resolve a move of
        # ~1e-7, the move is the (1 - d) share of p - e
        small = a.abs() < 1e-2
        want = ((1 - decay) * (p.detach().double() - a.double()))[small]
        num += ((e.double() - a.double())[small] - want).square().sum().item()
        den += want.square().sum().item()
    ema_share_err = (num / den) ** 0.5
    del p0, e0

    s_per_step = seconds / steps
    flops = train_flops_per_image(deco_c2i_flops())
    images_per_s = batch / s_per_step
    result = {"phase": "train", "config": "configs_c2i/DeCo_XL_freq.yaml", "batch": batch,
              "remat": "full", "warmup": warmup, "steps": steps, "losses": losses,
              "grad_norms": grad_norms, "s_per_step": s_per_step, "images_per_s": images_per_s,
              "train_flops_per_image": flops, "mfu": images_per_s * flops / card_peaks(card)[0],
              "peak_mem_bytes": peak_mem, "build_and_init_s": build_s,
              "launches": launches, "launches_per_step": {k: v / steps for k, v in launches.items()},
              "param_max_move": moved, "ema_max_move": ema_moved, "ema_rule_max_ulps": ema_ulps,
              "ema_share_rel_l2": ema_share_err,
              "card": card}
    emit(result)
    check(all(np.isfinite(losses + grad_norms)), "training loss or grad norm not finite")
    check(min(grad_norms) > 0, "zero gradient norm")
    check(moved > 0 and ema_moved > 0, "parameters or EMA did not move")
    check(ema_ulps <= 2 and ema_share_err < 0.05,
          f"EMA off e*d + p*(1-d): {ema_ulps} ulps, share rel L2 {ema_share_err}")
    expected = {"fwd_lse": 56 * steps, "bwd_dq": 28 * steps, "bwd_dkv": 28 * steps,
                "freq_mse": steps, "fwd": 0}
    check(launches == expected, f"training launches {launches}, expected {expected}")

    def one_step():
        fit.train(state, step, batches, 1, gen)
        torch.cuda.synchronize()

    emit({"phase": "train_breakdown", "batch": batch,
          **profile_breakdown(one_step, s_per_step * 1e3), "card": card})
    return launches


def _kernel_kind(name: str) -> str:
    if "flash_fwd_f32_kernel" in name:
        return "attention_fwd_f32"
    if "flash_fwd_kernel" in name:
        return "attention_fwd"
    if any(k in name for k in ATTN_BWD_KINDS):
        return "attention_bwd"
    if "freq_mse" in name:
        return "freq_mse"
    if any(s in name.lower() for s in ("gemm", "nvjet", "cutlass", "xmma")):
        return "gemm"
    return "other"  # elementwise, reductions, copies


def profile_breakdown(fn, wall_ms: float) -> dict:
    """Device time by kind of kernel over one more call of ``fn``, which ends
    in a synchronize, against ``wall_ms`` measured without the profiler. One
    stream, so the kernels do not overlap and idle = 1 - busy / wall."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
    rows, kinds = [], {}
    for ev in prof.key_averages():
        # user annotations (the optimizer's step range) enclose kernels counted already
        if ev.device_type != DeviceType.CUDA or ev.key.startswith("Optimizer."):
            continue
        ms = ev.self_device_time_total / 1e3
        rows.append((ev.key, ms, ev.count))
        kinds[_kernel_kind(ev.key)] = kinds.get(_kernel_kind(ev.key), 0.0) + ms
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(kinds.values())
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms, "idle_share": 1 - busy_ms / wall_ms,
            "kernels": sum(r[2] for r in rows), "by_kind_ms": kinds,
            "top": [{"kernel": k[:80], "ms": ms, "calls": n} for k, ms, n in rows[:8]]}


def device_breakdown(model, batch: int):
    """Device time by kernel over one CFG network call (``2 * batch`` rows).

    The wall time is taken without the profiler (median of 5 calls, each
    ended by a synchronize), then :func:`profile_breakdown` records one more.
    """
    import torch

    gen = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn(2 * batch, 256, 256, 3, generator=gen, device="cuda")
    t = torch.full((2 * batch,), 0.5, device="cuda")
    y = torch.arange(2 * batch, device="cuda")

    def call():
        with torch.no_grad():
            model(x, t, y)
        torch.cuda.synchronize()

    walls = []
    for _ in range(6):
        t0 = time.perf_counter()
        call()
        walls.append((time.perf_counter() - t0) * 1e3)
    return profile_breakdown(call, float(np.median(walls[1:])))


def phase_sample(model, card: str):
    import torch

    from deco_tpu_torch.models.autoencoders import fp_to_uint8
    from deco_tpu_torch.ops.flash_attention import flash_attention
    from deco_tpu_torch.sample import build_sampler, generate
    from deco_tpu_torch.utils.flops import card_peaks, deco_c2i_flops, sampler_flops_per_image

    batch, steps = 8, 50
    sampler = build_sampler("deco_xl_256", steps)
    generate(model, build_sampler("deco_xl_256", 2), batch, batch, 256)  # warm-up
    flash_attention.launches = 0
    t0 = time.perf_counter()
    images = generate(model, sampler, batch, batch, image_size=256)
    seconds = time.perf_counter() - t0  # ends in a copy to the host
    launches = flash_attention.launches
    stored = fp_to_uint8(images)
    segments = sampler._segment_table()
    net_rows = sum((2 if kind == "cfg" else 1) * (end - start) for start, end, kind in segments)
    cfg_factor = net_rows / steps
    flops_per_image = sampler_flops_per_image(deco_c2i_flops(), steps, cfg_factor)
    images_per_s = batch / seconds
    mfu = images_per_s * flops_per_image / card_peaks(card)[0]
    emit({"phase": "sample", "batch": batch, "steps": steps, "seconds": seconds,
          "images_per_s": images_per_s, "s_per_step": seconds / steps, "mfu": mfu,
          "flops_per_image": flops_per_image, "cfg_batch_factor": cfg_factor,
          "flash_launches": launches, "finite": bool(torch.isfinite(images).all()),
          "uint8_range": [int(stored.min()), int(stored.max())], "card": card})
    check(tuple(images.shape) == (batch, 256, 256, 3), "sample shape")
    check(bool(torch.isfinite(images).all()), "sampled images not finite")
    check(stored.dtype == torch.uint8 and tuple(stored.shape) == (batch, 256, 256, 3),
          "stored images are not uint8 NHWC")
    expected = len(model.blocks) * steps
    check(launches == expected == 1400, f"{launches} attention launches, expected 1400")
    emit({"phase": "breakdown", "batch_rows": 2 * batch, **device_breakdown(model, batch),
          "card": card})
    return launches


CLI_DIR = "build/chip_smoke_cli"  # git-ignored; deleted at the end of the phase
CLI_CONFIG = "configs_c2i/DeCo_XL_freq.yaml"
# phase 9's trunk depth (of 28), cut for the disk-write budget of one call
# (45 GiB): its checkpoint writes 2.0 GB, not 10.9 (14 blocks: 5.7), which
# leaves room for phase 15's 9.0 GB VAE-GAN checkpoint
CLI_TRUNK = 4
CLI_DEPTH = [f"--model.denoiser.init_args.num_cond_blocks={CLI_TRUNK}",
             f"--model.denoiser.init_args.num_blocks={CLI_TRUNK + 3}"]


def write_image_folder(root: str, seed: int, per_class: int = 32,
                       sizes=((320, 288), (288, 384))) -> int:
    """2 classes x ``per_class`` PNGs of the two ``sizes`` (H, W) in turn,
    from ``seed``, written with the port's encoder: the ADM crop resamples
    every one of them."""
    import os

    from deco_tpu_torch.utils import png

    rng = np.random.default_rng(seed)
    count = 0
    for c in range(2):
        os.makedirs(f"{root}/class_{c}", exist_ok=True)
        for i in range(per_class):
            h, w = sizes[i % 2]
            yy, xx = np.mgrid[0:h, 0:w]
            base = np.stack([xx * 255.0 / w, yy * 255.0 / h, np.full((h, w), 128.0 * c)], -1)
            image = np.clip(base + rng.normal(0, 25, (h, w, 3)), 0, 255).astype(np.uint8)
            png.write(f"{root}/class_{c}/{i:03d}.png", image)
            count += 1
    return count


class Spy:
    """Wraps ``owner.name`` for the phase: records each call's arguments,
    result and seconds, and puts the original back on exit. With
    ``replace`` the calls go to it in place of the original."""

    def __init__(self, owner, name: str, replace=None):
        self.owner, self.name, self.calls = owner, name, []
        self.original = getattr(owner, name)
        self.replace = replace

    def __enter__(self):
        original, calls = self.replace or self.original, self.calls

        def wrapped(*args, **kwargs):
            t0 = time.perf_counter()
            out = original(*args, **kwargs)
            calls.append({"args": args, "kwargs": kwargs, "out": out,
                          "seconds": time.perf_counter() - t0, "end": time.perf_counter()})
            return out

        setattr(self.owner, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self.original)
        return False


def _kernel_ms_by_kind(prof) -> dict:
    """Device milliseconds in kernels (not copies or fills of memory) in a
    trace, by :func:`_kernel_kind`."""
    from torch.autograd import DeviceType

    by_kind: dict = {}
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA and not ev.key.startswith(
                ("Memcpy", "Memset", "Optimizer.")):
            kind = _kernel_kind(ev.key)
            by_kind[kind] = by_kind.get(kind, 0.0) + ev.self_device_time_total / 1e3
    return by_kind


def _kernel_busy_ms(prof) -> float:
    """Device milliseconds in kernels (not copies or fills of memory) in a trace."""
    return sum(_kernel_ms_by_kind(prof).values())


def phase_cli(card: str, seed: int) -> dict:
    """The port's entry point as users run it: ``deco_tpu_torch.cli`` fit and
    predict on DeCo_XL_freq.yaml at full width, through an image folder,
    a checkpoint and the FID-protocol sample set."""
    import json
    import os
    import shutil

    import torch
    from torch.profiler import ProfilerActivity, profile

    from deco_tpu_torch import cli
    from deco_tpu_torch.config import registry
    from deco_tpu_torch.ops import block_dct
    from deco_tpu_torch.ops import flash_attention as fa
    from deco_tpu_torch.train import checkpoint

    config = registry.load_yaml(CLI_CONFIG)
    kernels = {"fwd_lse": fa.flash_attention_fwd_lse, "bwd_dq": fa.flash_attention_bwd_dq,
               "bwd_dkv": fa.flash_attention_bwd_dkv, "freq_mse": block_dct.freq_mse,
               "fwd": fa.flash_attention}
    steps = 3
    try:
        images = write_image_folder(f"{CLI_DIR}/images", seed)
        workroot = f"{CLI_DIR}/work"
        for f in kernels.values():
            f.launches = 0
        t0 = time.perf_counter()
        with Spy(checkpoint.CheckpointManager, "maybe_save") as saves, \
                profile(activities=[ProfilerActivity.CUDA]) as prof:
            state = cli.main(["fit", "-c", CLI_CONFIG, *CLI_DEPTH,
                              f"--data.train_dataset.init_args.root={CLI_DIR}/images",
                              f"--trainer.default_root_dir={workroot}", "--max_steps", str(steps),
                              "--trainer.log_every_n_steps=1"])
        fit_s = time.perf_counter() - t0
        fit_launches = {k: f.launches for k, f in kernels.items()}
        workdir = f"{workroot}/DeCo_256_XL_freq"
        records = [json.loads(line) for line in open(f"{workdir}/metrics.jsonl")]
        # each log reads the loss back, so record k's time is the end of step k
        ends = [r["time"] for r in records]
        step_s = [ends[0]] + [b - a for a, b in zip(ends, ends[1:])]
        busy_ms = _kernel_busy_ms(prof)
        ckpt_path = f"{workdir}/checkpoints/{steps}.pt"
        written = [c for c in saves.calls if c["out"]]
        names = [n for n, _ in state.model.named_parameters()]
        xl = len(state.model.blocks) == CLI_TRUNK and state.model.trunk_checkpoint
        obj = torch.load(ckpt_path, map_location="cpu", weights_only=True, mmap=True)
        keys_ok = (set(obj["state_dict"]) == {f"{p}{n}" for p in ("denoiser.", "ema_denoiser.")
                                              for n in names}
                   and set(obj["optimizer"]) == set(names)
                   and all(set(m) == {"exp_avg", "exp_avg_sq", "step"}
                           for m in obj["optimizer"].values()) and obj["step"] == steps)
        fit = {"phase": "cli_fit", "config": CLI_CONFIG, "images": images,
               "batch": config["data"]["train_batch_size"], "steps": steps,
               "losses": [r["loss"] for r in records], "step_s": step_s,
               "s_per_step": float(np.median(step_s[1:])),
               "device_kernel_ms": busy_ms, "idle_share": 1 - busy_ms / 1e3 / ends[-1],
               "fit_call_s": fit_s, "launches": fit_launches,
               "launches_per_step": {k: v / steps for k, v in fit_launches.items()},
               "checkpoint_bytes": os.path.getsize(ckpt_path),
               "checkpoint_save_s": [c["seconds"] for c in written],
               "checkpoint_keys_ok": keys_ok, "params": len(names), "card": card,
               "note": "timed under torch.profiler (CUDA activity); step_s from metrics.jsonl"}
        emit(fit)
        check(xl, f"the cli fit did not build DeCo-XL ({CLI_TRUNK} trunk blocks) with full remat")
        check(len(records) == steps and all(np.isfinite(fit["losses"])), f"cli fit losses {records}")
        # full remat: each trunk block's forward with lse runs twice a step
        expected = {"fwd_lse": 2 * CLI_TRUNK * steps, "bwd_dq": CLI_TRUNK * steps,
                    "bwd_dkv": CLI_TRUNK * steps,
                    "freq_mse": steps, "fwd": 0}
        check(fit_launches == expected, f"cli fit launches {fit_launches}, expected {expected}")
        check(keys_ok, "the cli checkpoint lacks keys")
        check(len(written) == 1, f"{len(written)} checkpoint saves, expected the final one")
        ema_saved = {n[len("ema_denoiser."):]: t for n, t in obj["state_dict"].items()
                     if n.startswith("ema_denoiser.")}
        del state, obj
        torch.cuda.empty_cache()

        for f in kernels.values():
            f.launches = 0
        t0 = time.perf_counter()
        with Spy(checkpoint.CheckpointManager, "restore_params") as restores:
            out = cli.main(["predict", "-c", CLI_CONFIG, *CLI_DEPTH,
                            f"--trainer.default_root_dir={workroot}",
                            f"--ckpt_path={workdir}/checkpoints", "--max_batches", "1"])
        predict_s = time.perf_counter() - t0
        sampling_s = time.perf_counter() - restores.calls[0]["end"]  # after the weights load
        pred_launches = {k: f.launches for k, f in kernels.items()}
        model = restores.calls[0]["args"][1]
        ema_equal = all(torch.equal(p.detach().cpu(), ema_saved[n])
                        for n, p in model.named_parameters())
        arr = np.load(out)["arr_0"]
        pngs = sorted(f for f in os.listdir(os.path.dirname(out)) if f.endswith(".png"))
        want_pngs = sorted(f"0_{i}.png" for i in range(10))  # class idx // 50, seed idx % 50
        emit({"phase": "cli_predict", "config": CLI_CONFIG, "batch": int(arr.shape[0]),
              "steps": config["model"]["diffusion_sampler"]["init_args"]["num_steps"],
              "predict_call_s": predict_s, "sampling_s": sampling_s,
              "images_per_s": arr.shape[0] / sampling_s, "launches": pred_launches,
              "npz_shape": list(arr.shape), "npz_dtype": str(arr.dtype),
              "pixel_std": float(arr.std()), "pngs": pngs, "ema_loaded_equal": ema_equal,
              "card": card})
        check(arr.shape == (20, 256, 256, 3) and arr.dtype == np.uint8, f"npz {arr.shape}")
        check(arr.std() > 0, "constant output.npz")
        check(pngs == want_pngs, f"sample files {pngs}")
        want = 100 * CLI_TRUNK  # 100 steps, CFG in one batched call a step
        check(pred_launches["fwd"] == want and sum(pred_launches.values()) == want,
              f"cli predict launches {pred_launches}, expected {want} forward")
        check(ema_equal, "the predict's weights differ from the saved EMA")
        print(card, flush=True)
        return {"fit": fit_launches, "predict": pred_launches}
    finally:
        shutil.rmtree(CLI_DIR, ignore_errors=True)


CLI_512_DIR = "build/chip_smoke_cli_512"  # git-ignored; deleted at the end of the phase
CLI_512_CONFIG = "configs_c2i/DeCo_XL_512.yaml"
# phase 10's trunk depth (of 28), cut as phase 9's: phases 14 (ReCo, 6.8 GB)
# and 15 (the VAE-GAN, 9.0 GB) write checkpoints too; 2.0 GB, not 10.9,
# keeps the call under 45 GiB
CLI_512_TRUNK = 4
CLI_512_DEPTH = [f"--model.denoiser.init_args.num_cond_blocks={CLI_512_TRUNK}",
                 f"--model.denoiser.init_args.num_blocks={CLI_512_TRUNK + 3}"]
# The FID tower on the card (fp32, TF32 off) against the same tower on the
# CPU: fp32 convolutions summed in other orders (and by other algorithms)
# agree to ~1e-6 of the largest feature; 1e-4 leaves room for cuDNN's
# algorithm choice and fails a wrong layer. The FID of 6 against 6 images
# is a difference of O(1e0-1e2) terms built from those features (float64
# moments on the host): rel 1e-3. SSIM is an fp32 mean of one depthwise
# convolution's ratios: rel 1e-5. PSNR comes from float64 sums of integer
# squares on both sides: equal.
FEATURE_REL = 1e-4
FID_REL = 1e-3
SSIM_REL = 1e-5


def _one_step(step, state, batch, gen) -> dict:
    """One train step under the profiler: seconds (host clock, ended by a
    synchronize), kernel milliseconds, idle share, peak memory, launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from deco_tpu_torch.ops import block_dct
    from deco_tpu_torch.ops import flash_attention as fa

    kernels = {"fwd_lse": fa.flash_attention_fwd_lse, "bwd_dq": fa.flash_attention_bwd_dq,
               "bwd_dkv": fa.flash_attention_bwd_dkv, "freq_mse": block_dct.freq_mse,
               "fwd": fa.flash_attention}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for f in kernels.values():
        f.launches = 0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        loss = float(step(state, batch, gen)["loss"])  # waits for the device
        seconds = time.perf_counter() - t0
    by_kind = _kernel_ms_by_kind(prof)
    busy_ms = sum(by_kind.values())
    return {"s_per_step": seconds, "loss": loss, "device_kernel_ms": busy_ms,
            "by_kind_ms": by_kind, "idle_share": 1 - busy_ms / 1e3 / seconds,
            "peak_mem_bytes": torch.cuda.max_memory_allocated(),
            "launches": {k: f.launches for k, f in kernels.items()}}


def _reference_batch(root: str, count: int, size: int) -> np.ndarray:
    """The first ``count`` images of the folder (sorted), ADM-cropped to ``size``."""
    import os

    from deco_tpu_torch.data.imagenet import adm_center_crop
    from deco_tpu_torch.utils import png

    paths = sorted(os.path.join(dp, f) for dp, _, fs in os.walk(root) for f in fs)
    return np.stack([adm_center_crop(png.read(p), size) for p in paths[:count]])


def _fid_of(features: np.ndarray, split: int) -> float:
    from deco_tpu_torch.train.metrics import FIDStats, frechet_distance

    stats = []
    for part in (features[:split], features[split:]):
        s = FIDStats(part.shape[1])
        s.update(part)
        stats.append(s.finalize())
    return frechet_distance(*stats[0], *stats[1])


def phase_cli_512(card: str, seed: int) -> dict:
    """DeCo-XL/16 at 512 px end to end, as users run it: ``cli fit`` on
    DeCo_XL_512.yaml (decoder_chunks 8, batch 16 x accumulation 2), one more
    step under each other remat policy and without chunks, ``cli predict``
    from the fit's checkpoint, then ``eval_fid`` and ``ComputeMetricsHook``
    on the card against the same computations on the CPU."""
    import json
    import os
    import shutil

    import torch
    from torch.profiler import ProfilerActivity, profile

    from deco_tpu_torch import cli, eval_fid
    from deco_tpu_torch.config import registry
    from deco_tpu_torch.models import inception
    from deco_tpu_torch.ops import block_dct
    from deco_tpu_torch.ops import flash_attention as fa
    from deco_tpu_torch.train import checkpoint
    from deco_tpu_torch.train.hooks import ComputeMetricsHook
    from deco_tpu_torch.train.train_step import make_train_step

    config = registry.load_yaml(CLI_512_CONFIG)
    denoiser = config["model"]["denoiser"]["init_args"]
    check(denoiser["decoder_chunks"] == 8 and config["trainer"]["accumulate_grad_batches"] == 2
          and config["data"]["train_batch_size"] == 16, f"{CLI_512_CONFIG} changed")
    kernels = {"fwd_lse": fa.flash_attention_fwd_lse, "bwd_dq": fa.flash_attention_bwd_dq,
               "bwd_dkv": fa.flash_attention_bwd_dkv, "freq_mse": block_dct.freq_mse,
               "fwd": fa.flash_attention}
    steps, step_batch = 3, 32  # 16 a microbatch, 2 microbatches a step
    try:
        # 3 steps of 32 images: one epoch, every image through the ADM crop to 512
        images = write_image_folder(f"{CLI_512_DIR}/images", seed, per_class=48,
                                    sizes=((576, 544), (544, 640)))
        workroot = f"{CLI_512_DIR}/work"
        torch.cuda.reset_peak_memory_stats()
        for f in kernels.values():
            f.launches = 0
        t0 = time.perf_counter()
        with Spy(checkpoint.CheckpointManager, "maybe_save") as saves, \
                profile(activities=[ProfilerActivity.CUDA]) as prof:
            state = cli.main(["fit", "-c", CLI_512_CONFIG, *CLI_512_DEPTH,
                              f"--data.train_dataset.init_args.root={CLI_512_DIR}/images",
                              f"--trainer.default_root_dir={workroot}", "--max_steps", str(steps),
                              "--trainer.log_every_n_steps=1"])
        fit_s = time.perf_counter() - t0
        fit_launches = {k: f.launches for k, f in kernels.items()}
        peak_mem = torch.cuda.max_memory_allocated()
        workdir = f"{workroot}/DeCo_512_XL"
        records = [json.loads(line) for line in open(f"{workdir}/metrics.jsonl")]
        ends = [r["time"] for r in records]
        step_s = [ends[0]] + [b - a for a, b in zip(ends, ends[1:])]
        busy_ms = _kernel_busy_ms(prof)
        written = [c for c in saves.calls if c["out"]]
        model = state.model
        fit = {"phase": "cli_512_fit", "config": CLI_512_CONFIG, "images": images,
               "image_size": 512, "batch": step_batch, "microbatch": 16,
               "decoder_chunks": model.decoder_chunks, "remat": model.trunk_remat_policy,
               "steps": steps, "losses": [r["loss"] for r in records], "step_s": step_s,
               "s_per_step": float(np.median(step_s[1:])), "device_kernel_ms": busy_ms,
               "idle_share": 1 - busy_ms / 1e3 / ends[-1], "peak_mem_bytes": peak_mem,
               "fit_call_s": fit_s, "launches": fit_launches,
               "launches_per_step": {k: v / steps for k, v in fit_launches.items()},
               "checkpoint_save_s": [c["seconds"] for c in written], "card": card,
               "note": "timed under torch.profiler (CUDA activity); step_s from metrics.jsonl"}
        emit(fit)
        check(len(model.blocks) == CLI_512_TRUNK and model.hidden_size == 1152
              and model.num_groups == 16 and len(model.dec_net.res_blocks) == 3
              and model.patch_size == 16, "the cli fit did not build DeCo-XL/16 (cut trunk)")
        check(model.trunk_checkpoint and model.trunk_remat_policy == "full"
              and model.decoder_chunks == 8, "the 512 config's remat and decoder_chunks")
        check(len(records) == steps and all(np.isfinite(fit["losses"])), f"cli 512 fit {records}")
        per_step = 2 * CLI_512_TRUNK  # 2 microbatches a step
        expected = {"fwd_lse": 2 * per_step * steps, "bwd_dq": per_step * steps,
                    "bwd_dkv": per_step * steps, "freq_mse": 0, "fwd": 0}
        check(fit_launches == expected, f"cli 512 fit launches {fit_launches}, expected {expected}")
        check(len(written) == 1, f"{len(written)} checkpoint saves, expected the final one")

        # one more step under each remat policy, and without decoder chunks,
        # on a batch already on the card (the fit's objective, optimizer and EMA)
        trainer = registry.instantiate(config["model"]["diffusion_trainer"])
        step = make_train_step(trainer, ema_decay=0.9999, accumulate_grad_batches=2)
        gen = torch.Generator(device="cuda").manual_seed(seed)
        x = torch.rand(step_batch, 512, 512, 3, generator=gen, device="cuda") * 2 - 1
        labels = torch.arange(step_batch, device="cuda") % 1000
        batch = dict(x=x, condition=labels, uncondition=torch.full_like(labels, 1000))
        variants = {}
        for policy, chunks in (("full", 8), ("attn", 8), ("dots", 8), ("full", 0)):
            model.trunk_remat_policy, model.decoder_chunks = policy, chunks
            row = _one_step(step, state, batch, gen)
            variants[f"{policy}_chunks{chunks}"] = row
            emit({"phase": "cli_512_step", "remat": policy, "decoder_chunks": chunks,
                  "batch": step_batch, "microbatch": 16, **row, "card": card,
                  "note": "one step on a batch on the card, under torch.profiler"})
            check(np.isfinite(row["loss"]), f"{policy}/{chunks}: loss not finite")
            lse = per_step if policy == "attn" else 2 * per_step
            want = {"fwd_lse": lse, "bwd_dq": per_step, "bwd_dkv": per_step, "freq_mse": 0,
                    "fwd": 0}
            check(row["launches"] == want, f"{policy}/{chunks} launches {row['launches']}, "
                                           f"expected {want}")
        model.trunk_remat_policy, model.decoder_chunks = "full", 8
        del state, model, step, batch, x
        torch.cuda.empty_cache()

        for f in kernels.values():
            f.launches = 0
        t0 = time.perf_counter()
        with Spy(checkpoint.CheckpointManager, "restore_params") as restores:
            out = cli.main(["predict", "-c", CLI_512_CONFIG, *CLI_512_DEPTH,
                            f"--trainer.default_root_dir={workroot}",
                            f"--ckpt_path={workdir}/checkpoints", "--max_batches", "1"])
        predict_s = time.perf_counter() - t0
        sampling_s = time.perf_counter() - restores.calls[0]["end"]
        pred_launches = {k: f.launches for k, f in kernels.items()}
        samples = np.load(out)["arr_0"]
        emit({"phase": "cli_512_predict", "config": CLI_512_CONFIG, "batch": int(samples.shape[0]),
              "steps": config["model"]["diffusion_sampler"]["init_args"]["num_steps"],
              "guidance": config["model"]["diffusion_sampler"]["init_args"]["guidance"],
              "predict_call_s": predict_s, "sampling_s": sampling_s,
              "images_per_s": samples.shape[0] / sampling_s, "launches": pred_launches,
              "npz_shape": list(samples.shape), "npz_dtype": str(samples.dtype),
              "pixel_std": float(samples.std()), "card": card})
        check(samples.shape == (6, 512, 512, 3) and samples.dtype == np.uint8,
              f"npz {samples.shape} {samples.dtype}")
        check(samples.std() > 0, "constant output.npz")
        want = 100 * CLI_512_TRUNK  # 100 steps, CFG in one batched call a step
        check(pred_launches["fwd"] == want and sum(pred_launches.values()) == want,
              f"cli 512 predict launches {pred_launches}, expected {want} forward")
        torch.cuda.empty_cache()

        # score: eval_fid and ComputeMetricsHook on the card, each against the
        # same computation on the CPU, with the tower drawn from seed 0
        reference = _reference_batch(f"{CLI_512_DIR}/images", len(samples), 512)
        ref_path = f"{CLI_512_DIR}/reference.npz"
        np.savez(ref_path, arr_0=reference)
        t0 = time.perf_counter()
        fid_card = eval_fid.main([out, ref_path])
        eval_s = time.perf_counter() - t0
        fid_cpu = eval_fid.main([out, ref_path, "--device", "cpu"])
        both = np.concatenate([samples, reference]).astype(np.float32) / 255.0
        tower_cpu = inception.random_inception(0, device="cpu")
        tower_card = inception.random_inception(0, device="cuda")
        feats_cpu = inception.compute_fid_features(both, tower_cpu)
        feats_card = inception.compute_fid_features(both, tower_card)
        feature_rel = float(np.abs(feats_card - feats_cpu).max() / np.abs(feats_cpu).max())
        saved = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = True  # what TF32 convolutions would give
        try:
            with torch.no_grad():
                feats_tf32 = tower_card._features(torch.from_numpy(both).cuda()).cpu().numpy()
        finally:
            torch.backends.cudnn.allow_tf32 = saved
        tf32_rel = float(np.abs(feats_tf32 - feats_cpu).max() / np.abs(feats_cpu).max())
        n = len(samples)
        hook_card = ComputeMetricsHook(device="cuda")
        hook_cpu = ComputeMetricsHook(device="cpu", inception=tower_cpu)
        for hook in (hook_card, hook_cpu):
            hook.on_batch_end(samples, reference)
        scores_card, scores_cpu = hook_card.on_epoch_end(), hook_cpu.on_epoch_end()
        x64 = torch.rand(64, 512, 512, 3, device="cuda")
        with torch.no_grad():
            tower_ms = cuda_ms(lambda: tower_card(x64), 10)

        def rel(a, b):
            return abs(a - b) / abs(b)

        score = {"phase": "cli_512_score", "samples": n, "reference": len(reference),
                 "tower": "random, seed 0 (no published weights in the repository)",
                 "fid_card": fid_card, "fid_cpu": fid_cpu, "fid_rel": rel(fid_card, fid_cpu),
                 "fid_from_features_cpu": _fid_of(feats_cpu, n),
                 "feature_max_rel_err": feature_rel, "feature_rel_limit": FEATURE_REL,
                 "fid_rel_limit": FID_REL, "tf32_feature_max_rel_err": tf32_rel,
                 "tf32_fid": _fid_of(feats_tf32, n),
                 "tf32_fid_rel": rel(_fid_of(feats_tf32, n), _fid_of(feats_cpu, n)),
                 "hook_card": scores_card, "hook_cpu": scores_cpu,
                 "eval_fid_card_s": eval_s, "tower_ms_batch64": tower_ms,
                 "tower_images_per_s": 64 / tower_ms * 1e3,
                 "tower_note": "2048-d, fp32, TF32 off, 512 px inputs, CUDA events", "card": card}
        emit(score)
        check(np.isfinite([fid_card, fid_cpu]).all(), "FID not finite")
        check(feature_rel < FEATURE_REL, f"tower features card vs CPU {feature_rel}")
        check(rel(fid_card, fid_cpu) < FID_REL, f"eval_fid card {fid_card} vs CPU {fid_cpu}")
        check(scores_card["metrics/psnr"] == scores_cpu["metrics/psnr"], "hook PSNR card vs CPU")
        check(rel(scores_card["metrics/ssim"], scores_cpu["metrics/ssim"]) < SSIM_REL,
              "hook SSIM card vs CPU")
        check(rel(scores_card["metrics/fid"], scores_cpu["metrics/fid"]) < FID_REL,
              "hook FID card vs CPU")
        check(rel(scores_card["metrics/fid"], fid_card) < FID_REL, "hook FID vs eval_fid")
        print(card, flush=True)
        return {"fit": fit_launches, "predict": pred_launches,
                "attn": variants["attn_chunks8"]["launches"]}
    finally:
        shutil.rmtree(CLI_512_DIR, ignore_errors=True)


# ---- t2i: DeCo-XXL/16 text-to-image serving (configs_t2i/sft_res512.yaml) ----

T2I_CONFIG = "configs_t2i/sft_res512.yaml"
T2I_DIR = "build/chip_smoke_t2i"  # git-ignored; deleted at the end of the phase
# The t2i slice, card vs CPU, both bf16: 4 AdamLM steps of a 2 joint + 1 text
# block DeCoT2I at full width on two canvases. On the CPU
# (`--calibrate-t2i-slice`) its bf16 images differ from fp32 by rel L2 0.0232,
# and zeroing every attention of the trunk moves them by 0.0755; 0.045 sits
# between (1.9x the first, 1/1.7 of the second), so it passes rounding and
# fails a wrong attention, as SLICE_REL_L2 does for c2i.
T2I_SLICE_REL_L2 = 0.045
T2I_SLICE_READINGS = {"bf16_vs_fp32": 0.0232, "zero_attention_vs_bf16": 0.0755}
T2I_SLICE = dict(num_encoder_blocks=2, num_text_blocks=1)  # full width, cut depth
T2I_CANVASES = ((512, 512), (544, 480))  # the second: 1,020 image tokens, both lengths ragged
T2I_SLICE_STEPS = 4


def t2i_flops_per_call(image_tokens: int, text_tokens: int = 128, hidden: int = 1536,
                       joint_blocks: int = 16, text_blocks: int = 4, patch: int = 16,
                       decoder_width: int = 32, decoder_blocks: int = 3,
                       txt_embed_dim: int = 2048) -> float:
    """Matmul FLOPs of one DeCo-XXL/16 t2i network call, per row (one image).

    A joint block: qkv_x 2NC*3C, kv_y 2MC*2C, attention 4N(N+M)C, proj 2NC^2,
    the fused SwiGLU of width 4C 3*2NC*4C, adaLN 2C*6C; a text block the same
    over M tokens with qkv 2MC*3C and attention 4M^2C; the embedders 2N(P^2*3)C
    and 2M*txt*C; the decoder as in ``utils/flops.deco_pixel_decoder_flops``.
    At 512 px (N = 1024, M = 128): 16 joint blocks 1.373 TFLOP, 4 text blocks
    0.039, decoder 0.036, embedders 0.003: 1.45 TFLOP.
    """
    from deco_tpu_torch.utils.flops import deco_pixel_decoder_flops

    n, m, c = image_tokens, text_tokens, hidden
    mlp = 3 * 2 * c * 4 * c
    adaln = 2 * c * 6 * c
    joint = n * (2 * c * 3 * c + 2 * c * c + mlp) + m * 2 * c * 2 * c + 4 * n * (n + m) * c + adaln
    text = m * (2 * c * 3 * c + 2 * c * c + mlp) + 4 * m * m * c + adaln
    embed = 2 * n * patch * patch * 3 * c + 2 * m * txt_embed_dim * c
    dec = deco_pixel_decoder_flops(n, patch, decoder_width, c, decoder_blocks)
    return float(joint_blocks * joint + text_blocks * text + embed + dec)


def phase_t2i_kernel(card: str) -> dict:
    """The flash forward at the t2i shapes (D = 64): joint attention (image
    queries over 1,024 image + 128 text keys), text refinement (128 x 128),
    at the serve batch (2 prompts, CFG: B*H 96) and the CLI predict batch (8
    prompts: B*H 384), and the ragged 544x480 canvas; against the plain
    version, bit-identical over two runs, timed beside bound and cuDNN."""
    import torch

    from deco_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain

    gen = torch.Generator(device="cuda").manual_seed(8)
    shapes = {  # (B, Nq, Nkv, H, D)
        "joint_96": (4, 1024, 1152, 24, 64), "text_96": (4, 128, 128, 24, 64),
        "joint_384": (16, 1024, 1152, 24, 64), "text_384": (16, 128, 128, 24, 64),
        "ragged_96": (4, 1020, 1148, 24, 64),
    }
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")  # > the 50 MB L2
    rows, worst = {}, 0.0
    for name, (b, nq, nkv, h, d) in shapes.items():
        q = torch.randn(b, nq, h, d, generator=gen, device="cuda").to(torch.bfloat16)
        k, v = (torch.randn(b, nkv, h, d, generator=gen, device="cuda").to(torch.bfloat16)
                for _ in range(2))
        out, again = flash_attention(q, k, v), flash_attention(q, k, v)
        torch.cuda.synchronize()
        ref = flash_attention_plain(q, k, v)
        err = (out.float() - ref.float()).abs().max().item()
        check(bool(torch.isfinite(out).all()), f"t2i attention {name}: not finite")
        check(err < ATTN_ATOL, f"t2i attention {name} error {err} >= {ATTN_ATOL}")
        check(torch.equal(out, again), f"t2i attention {name} differs between two runs")
        worst = max(worst, err)
        nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
        rows[name] = {
            "b_nq_nkv_h_d": [b, nq, nkv, h, d], "bh": b * h, "max_abs_err": err,
            "bit_identical": True, "ms": cuda_ms(lambda: flash_attention(q, k, v), 30, flush),
            "plain_ms": cuda_ms(lambda: flash_attention_plain(q, k, v), 5, flush),
            **sdpa_forward_yardsticks(q, k, v, d ** -0.5, False, flush, 30),
            **_bound(card, nbytes, 4 * b * h * nq * nkv * d)}
        emit({"phase": "t2i_kernel", "shape": name, **rows[name], "atol": ATTN_ATOL,
              "l2": "flushed before each call", "card": card})
        del q, k, v, out, again, ref
    return {"max_abs_err": worst, "timings": rows}


def t2i_slice_images(device: str, dtype=None, zero_attention: bool = False) -> list:
    """The cut-depth DeCoT2I (full width, 2 joint + 1 text blocks, seeded
    random weights) sampled with ``T2I_SLICE_STEPS`` AdamLM steps (order 2,
    CFG 4.0, time shift 3.0) on each canvas of ``T2I_CANVASES``, from seeded
    noise and seeded text embeddings (0.02 * randn, the hash encoder's scale;
    Python's salted ``hash()`` would tie the prompt to the process): the
    final images, float32 on the CPU. ``zero_attention`` makes every
    attention of the trunk return zeros (the reading that sets the gate)."""
    import torch

    from deco_tpu_torch.diffusion.adam_sampling import AdamLMSampler
    from deco_tpu_torch.diffusion.scheduling import LinearScheduler
    from deco_tpu_torch.models import layers
    from deco_tpu_torch.models.dit_c2i_deco import init_random_
    from deco_tpu_torch.models.dit_t2i import DeCoT2I

    model = init_random_(DeCoT2I(**T2I_SLICE, dtype=dtype or torch.bfloat16, device=device),
                         seed=1).eval()
    sampler = AdamLMSampler(scheduler=LinearScheduler(), order=2, num_steps=T2I_SLICE_STEPS,
                            guidance=4.0, timeshift=3.0)
    gen = torch.Generator().manual_seed(2)
    cond = (torch.randn(1, 128, 2048, generator=gen) * 0.02).to(torch.bfloat16).to(device)
    uncond = (torch.randn(1, 128, 2048, generator=gen) * 0.02).to(torch.bfloat16).to(device)
    saved = layers.sdpa
    if zero_attention:
        layers.sdpa = lambda q, k, v, mask=None, causal=False: torch.zeros_like(q)
    try:
        images = []
        for h, w in T2I_CANVASES:
            noise = torch.randn(1, h, w, 3, generator=gen).to(device)
            scale = (h / 512, w / 512)
            x = sampler(lambda x, t, y: model(x, t, y, patch_scaling_hw=scale), noise, cond,
                        uncond)
            images.append(x.float().cpu())
    finally:
        layers.sdpa = saved
    return images


def _rel_l2_images(a: list, b: list) -> float:
    """Relative L2 distance of two lists of images, taken as one vector each."""
    import torch

    return _rel_l2(*(torch.cat([x.reshape(-1) for x in images]) for images in (a, b)))


def calibrate_t2i_slice() -> None:
    """The two CPU readings between which T2I_SLICE_REL_L2 sits."""
    import torch

    fp32 = t2i_slice_images("cpu", torch.float32)
    bf16 = t2i_slice_images("cpu")
    zero = t2i_slice_images("cpu", zero_attention=True)
    emit({"phase": "calibrate_t2i_slice", "bf16_vs_fp32_rel_l2": _rel_l2_images(bf16, fp32),
          "zero_attention_vs_bf16_rel_l2": _rel_l2_images(zero, bf16)})


def phase_t2i_slice():
    from deco_tpu_torch.ops.flash_attention import flash_attention

    results = {}
    for device in ("cuda", "cpu"):
        before = flash_attention.launches
        t0 = time.perf_counter()
        results[device] = t2i_slice_images(device)
        results[device + "_s"] = time.perf_counter() - t0
        results[device + "_launches"] = flash_attention.launches - before
    rel_l2 = _rel_l2_images(results["cuda"], results["cpu"])
    per_canvas = [_rel_l2(a.reshape(-1), b.reshape(-1))
                  for a, b in zip(results["cuda"], results["cpu"])]
    want = len(T2I_CANVASES) * T2I_SLICE_STEPS * 3  # 2 joint + 1 text attention a call
    emit({"phase": "t2i_slice_vs_plain", **T2I_SLICE, "steps": T2I_SLICE_STEPS,
          "canvases": T2I_CANVASES, "rel_l2": rel_l2, "rel_l2_per_canvas": per_canvas,
          "rel_l2_limit": T2I_SLICE_REL_L2, "calibration": T2I_SLICE_READINGS,
          "cuda_flash_launches": results["cuda_launches"],
          "cpu_flash_launches": results["cpu_launches"], "cuda_s": results["cuda_s"],
          "cpu_s": results["cpu_s"]})
    check(all(bool(x.isfinite().all()) for x in results["cuda"]), "t2i slice images not finite")
    check(results["cuda_launches"] == want,
          f"t2i slice launched {results['cuda_launches']} kernels, expected {want}")
    check(results["cpu_launches"] == 0, "the CPU t2i slice launched a kernel")
    check(rel_l2 < T2I_SLICE_REL_L2, f"t2i slice card vs CPU rel L2 {rel_l2} >= "
                                     f"{T2I_SLICE_REL_L2}")


def _t2i_call_breakdown(pipe, rows: int, wall_ms: float) -> dict:
    """Device time of one CFG network call of ``rows`` rows at 512 px by kind:
    the 4 text attentions run before the 16 joint ones, so the first 4
    forward kernels in time order are the text attention's."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn(rows, 512, 512, 3, generator=gen, device="cuda")
    t = torch.full((rows,), 0.5, device="cuda")
    y = (torch.randn(rows, 128, 2048, generator=gen, device="cuda") * 0.02).to(torch.bfloat16)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with torch.no_grad():
            pipe.denoiser(x, t, y)
        torch.cuda.synchronize()
    kernels = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
    kinds = {"text_attention": 0.0, "joint_attention": 0.0, "gemm": 0.0, "other": 0.0}
    attention = [e for e in kernels if "flash_fwd_kernel" in e.name]
    text = set(map(id, attention[:4]))
    for e in kernels:
        ms = e.time_range.elapsed_us() / 1e3
        if "flash_fwd_kernel" in e.name:
            kinds["text_attention" if id(e) in text else "joint_attention"] += ms
        else:
            kinds["gemm" if _kernel_kind(e.name) == "gemm" else "other"] += ms
    busy = sum(kinds.values())
    return {"rows": rows, "wall_ms": wall_ms, "device_busy_ms": busy,
            "idle_share": 1 - busy / wall_ms, "kernels": len(kernels),
            "attention_kernels": len(attention), "by_kind_ms": kinds}


def phase_t2i_serve(card: str) -> int:
    """``serve.load_pipeline(sft_res512.yaml)`` at full width (DeCo-XXL/16,
    random init_like_jax_ weights, the hash text encoder): 2 prompts at
    512x512, 25 AdamLM steps, order 2, CFG 4.0, time shift 3.0, with
    trajectories; then ``serve.main`` once as a user runs it."""
    import os
    import shutil

    import torch

    from deco_tpu_torch import serve
    from deco_tpu_torch.ops.flash_attention import flash_attention
    from deco_tpu_torch.utils import png
    from deco_tpu_torch.utils.flops import card_peaks

    prompts = ["a photo of a red fox in the snow", "two cups of coffee on a wooden table"]
    steps = 25
    try:
        t0 = time.perf_counter()
        pipe = serve.load_pipeline(T2I_CONFIG)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        model = pipe.denoiser
        params = sum(p.numel() for p in model.parameters())
        check(len(model.blocks) == 16 and len(model.text_refine_blocks) == 4
              and model.hidden_size == 1536 and model.num_groups == 24,
              "serve did not build DeCo-XXL/16")
        pipe(prompts, num_steps=2)  # warm-up: the caches and the cuBLAS handles
        calls = []
        for _ in range(2):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            flash_attention.launches = 0
            t0 = time.perf_counter()
            images, trajs = pipe(prompts, height=512, width=512, num_steps=steps, order=2,
                                 cfg=4.0, timeshift=3.0, seed=0, return_trajectories=True)
            seconds = time.perf_counter() - t0  # ends in copies to the host
            calls.append({"seconds": seconds, "s_per_image": seconds / len(prompts),
                          "images_per_s": len(prompts) / seconds,
                          "launches": flash_attention.launches,
                          "peak_mem_bytes": torch.cuda.max_memory_allocated()})
        images = np.stack(images)
        # step 0 runs conditional-only (t = 0 is outside the open guidance
        # interval), the other 24 CFG-doubled
        flops = t2i_flops_per_call(1024) * (1 + 2 * (steps - 1))
        for c in calls:
            c["mfu"] = c["images_per_s"] * flops / card_peaks(card)[0]
        os.makedirs(T2I_DIR, exist_ok=True)
        png.write_apng(f"{T2I_DIR}/traj.png", trajs[0])
        frames, delays = png.read_apng(f"{T2I_DIR}/traj.png")
        frames_ok = len(frames) == steps + 1 and all(
            np.array_equal(a, b) for a, b in zip(frames, trajs[0]))
        walls = []
        for _ in range(4):
            gen = torch.Generator(device="cuda").manual_seed(4)
            x = torch.randn(4, 512, 512, 3, generator=gen, device="cuda")
            y = torch.zeros(4, 128, 2048, device="cuda", dtype=torch.bfloat16)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.no_grad():
                model(x, torch.full((4,), 0.5, device="cuda"), y)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        breakdown = _t2i_call_breakdown(pipe, 4, float(np.median(walls[1:])))
        emit({"phase": "t2i_serve", "config": T2I_CONFIG, "params": params,
              "prompts": len(prompts), "size": [512, 512], "steps": steps, "order": 2,
              "cfg": 4.0, "timeshift": 3.0, "load_s": load_s, "calls": calls,
              "flops_per_image": flops, "images_shape": list(images.shape),
              "images_dtype": str(images.dtype), "frames": len(trajs[0]),
              "apng_frames_equal": frames_ok, "apng_delays_ms": sorted(set(delays)),
              "one_network_call": breakdown, "card": card})
        check(images.shape == (2, 512, 512, 3) and images.dtype == np.uint8, "serve images")
        check(all(c["launches"] == 20 * steps for c in calls),
              f"serve launches {[c['launches'] for c in calls]}, expected {20 * steps}")
        check(frames_ok and delays == [100.0] * (steps + 1), "the trajectory APNG")
        check(breakdown["attention_kernels"] == 20, f"one network call ran "
                                                    f"{breakdown['attention_kernels']} attentions")
        del pipe, model
        torch.cuda.empty_cache()

        flash_attention.launches = 0
        t0 = time.perf_counter()
        paths = serve.main(["--config", T2I_CONFIG, "--prompt", prompts[0], "--prompt",
                            prompts[1], "--negative_prompt", "blurry", "--out_dir",
                            f"{T2I_DIR}/serve"])
        main_s = time.perf_counter() - t0
        written = sorted(os.listdir(f"{T2I_DIR}/serve"))
        samples = [png.read(p) for p in paths]
        traj_frames = [len(png.read_apng(f"{T2I_DIR}/serve/traj_{i}.png")[0]) for i in range(2)]
        emit({"phase": "t2i_serve_main", "seconds": main_s, "files": written,
              "launches": flash_attention.launches, "traj_frames": traj_frames,
              "sample_shapes": [list(x.shape) for x in samples], "card": card})
        check(written == ["sample_0.png", "sample_1.png", "traj_0.png", "traj_1.png"],
              f"serve.main wrote {written}")
        check(traj_frames == [steps + 1] * 2 and all(x.shape == (512, 512, 3) for x in samples),
              "serve.main outputs")
        check(flash_attention.launches == 20 * steps, "serve.main launches")
        print(card, flush=True)
        return calls[-1]["launches"]
    finally:
        shutil.rmtree(T2I_DIR, ignore_errors=True)


def phase_t2i_predict(card: str) -> int:
    """``python -m deco_tpu_torch.cli predict -c configs_t2i/sft_res512.yaml``
    in this process: one batch of 8 (the first 2 DPG prompts x 4 seeds), 25
    AdamLM steps with CFG on 16 rows, the JAX initializers' random weights
    (no checkpoint) and the hash text encoder; 8 PNGs named
    ``<prompt file>_<seed>.png``."""
    import os
    import shutil

    import torch

    from deco_tpu_torch import cli
    from deco_tpu_torch.ops.flash_attention import flash_attention
    from deco_tpu_torch.train import loop
    from deco_tpu_torch.utils import png

    try:
        flash_attention.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with Spy(loop, "init_like_jax_") as inits:
            cli.main(["predict", "-c", T2I_CONFIG, f"--trainer.default_root_dir={T2I_DIR}",
                      "--max_batches", "1"])
        predict_s = time.perf_counter() - t0
        sampling_s = time.perf_counter() - inits.calls[0]["end"]  # after the weights
        out_dir = f"{T2I_DIR}/sftpix512ema/val_200k/iter_0"
        names = sorted(os.listdir(out_dir))
        images = [png.read(os.path.join(out_dir, n)) for n in names]
        want = sorted(f"{p}_{s}.png" for p in ("0", "1") for s in range(4))
        emit({"phase": "t2i_predict", "config": T2I_CONFIG, "batch": len(images),
              "predict_call_s": predict_s, "sampling_s": sampling_s,
              "images_per_s": len(images) / sampling_s, "launches": flash_attention.launches,
              "peak_mem_bytes": torch.cuda.max_memory_allocated(), "files": names,
              "pixel_std": float(np.std(images)), "card": card})
        check(names == want, f"predict wrote {names}")
        check(all(x.shape == (512, 512, 3) and x.dtype == np.uint8 for x in images),
              "predict images")
        check(flash_attention.launches == 500, f"predict launches {flash_attention.launches}")
        print(card, flush=True)
        return flash_attention.launches
    finally:
        shutil.rmtree(T2I_DIR, ignore_errors=True)


# ---- phase 12: t2i training (configs_t2i/sft_res512.yaml) ----

# (B, Nq, Nkv, H, D) of sft_res512.yaml's attention at microbatch 16 (batch
# 16 x accumulation 4): joint (1,024 image queries over 1,024 image + 128
# text keys), a 544x480 canvas (1,020 over 1,148), the text refinement
T2I_TRAIN_SHAPES = {"joint": (16, 1024, 1152, 24, 64), "ragged": (16, 1020, 1148, 24, 64),
                    "text": (16, 128, 128, 24, 64)}
# The one-step t2i train slice (2 joint + 1 text blocks at full width, batch
# 2 at 512 px), card vs CPU, both bf16 compute with fp32 parameters. The
# gates sit between the CPU readings of --calibrate-t2i-train-slice (bf16 vs
# fp32, and a zeroed attention backward vs bf16; T2I_TRAIN_SLICE_READINGS),
# set before the first card run: the gradients of all parameters and, by
# name, of the text side (every kv_y, the y_embedder), which only the text
# half of dK/dV reaches. The loss, which the backward cannot move, is held to
# 10x its bf16-vs-fp32 reading. Two independent bf16 roundings (card, CPU)
# should read ~1.4x the bf16-vs-fp32 numbers.
T2I_TRAIN_SLICE_GATES = {"loss_rel": 8e-3, "all": 0.015, "kv_y": 0.05, "y_embedder": 0.05}
T2I_TRAIN_SLICE_READINGS = {
    "bf16_vs_fp32": {"loss_rel": 7.6e-4, "all": 0.0043, "kv_y": 0.0079, "y_embedder": 0.0081},
    "zero_attention_backward_vs_bf16": {"loss_rel": 0.0, "all": 0.0326, "kv_y": 1.0,
                                        "y_embedder": 1.0}}
T2I_FIT_DIR = "build/chip_smoke_t2i_fit"  # git-ignored; deleted at the end of the phase
T2I_FIT_STEPS = 3
# per optimizer step at batch 16 x 4 (no remat): 4 microbatches x (16 joint + 4 text)
T2I_FIT_LAUNCHES = {"fwd_lse": 80, "bwd_dq": 80, "bwd_dkv": 80, "fwd": 0, "freq_mse": 0}


def phase_t2i_train_kernels(card: str) -> dict:
    """The forward with lse, dQ and dK/dV at the t2i training shapes
    (D = 64) against their plain versions, then timed beside their bounds,
    the plain versions and the SDPA yardsticks."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(12)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")  # > the 50 MB L2
    errs = {"fwd_lse": 0.0, "bwd_dq": 0.0, "bwd_dkv": 0.0}
    timings: dict = {"fwd_lse": {}, "bwd_dq": {}, "bwd_dkv": {}}
    for name, shape in T2I_TRAIN_SHAPES.items():
        row = hold_attention_training("t2i_train_kernels", name, shape,
                                      attention_operands(gen, *shape))
        for key, value in row["errs"].items():
            errs[key] = max(errs[key], value)
        for kernel, timing in _attention_timings(card, attention_operands(gen, *shape), flush,
                                                 20).items():
            timings[kernel][name] = timing
            emit({"phase": "t2i_train_kernels", "timing": f"{kernel}_{name}",
                  "b_nq_nkv_h_d": shape, **timing, "l2": "flushed before each call",
                  "card": card})
    return {"errs": errs, "timings": timings}


def t2i_train_slice_step(device: str, dtype=None, zero_attention_backward: bool = False):
    """One sft_res512.yaml training step (its DeCoTrainer, AdamW and
    gradient clip) of the cut-depth DeCoT2I (2 joint + 1 text blocks, full
    width, fp32 parameters, seeded random weights) at batch 2 on 512x512:
    (loss, {"all", "kv_y", "y_embedder": flat gradient}) as fp32 on the CPU.
    The batch, the text embeddings (0.02 * randn, the hash encoder's
    scale) and the draws (one row's condition dropped, both t branches) come
    from fixed seeds; ``zero_attention_backward`` makes the attention
    backward return zeros (the reading that sets the gates)."""
    import torch

    from deco_tpu_torch.config import registry
    from deco_tpu_torch.models.dit_c2i_deco import init_random_
    from deco_tpu_torch.models.dit_t2i import DeCoT2I
    from deco_tpu_torch.ops import flash_attention as fa
    from deco_tpu_torch.train.train_step import make_train_step

    config = registry.load_yaml(T2I_CONFIG)
    model = init_random_(DeCoT2I(**T2I_SLICE, dtype=dtype or torch.bfloat16,
                                 param_dtype=torch.float32, device=device), seed=1)
    state = registry.instantiate(config["model"]["optimizer"]).create_state(model.train())
    step = make_train_step(registry.instantiate(config["model"]["diffusion_trainer"]),
                           grad_clip=config["trainer"]["gradient_clip_val"])
    rng = np.random.default_rng(2)
    batch = {"x": rng.uniform(-1, 1, (2, 512, 512, 3)),
             "condition": rng.standard_normal((2, 128, 2048)) * 0.02,
             "uncondition": rng.standard_normal((2, 128, 2048)) * 0.02}
    batch = {k: torch.from_numpy(v.astype(np.float32)).to(device) for k, v in batch.items()}
    draws = dict(drop_u=np.array([0.9, 0.05], np.float32),  # p = 0.1: the second row dropped
                 t_normal=rng.standard_normal(2).astype(np.float32),
                 t_uniform=rng.uniform(size=2).astype(np.float32),
                 mix_u=np.array([0.5, 0.95], np.float32),  # both t branches
                 noise=rng.standard_normal((2, 512, 512, 3)).astype(np.float32))
    saved = fa.flash_attention_bwd
    if zero_attention_backward:
        fa.flash_attention_bwd = lambda q, k, v, *_: tuple(map(torch.zeros_like, (q, k, v)))
    try:
        metrics = step(state, batch, draws=[draws])
    finally:
        fa.flash_attention_bwd = saved
    named = [(n, p.grad.reshape(-1).float().cpu()) for n, p in model.named_parameters()]
    groups = {"all": torch.cat([g for _, g in named]),
              "kv_y": torch.cat([g for n, g in named if ".attn.kv_y." in n]),
              "y_embedder": torch.cat([g for n, g in named if n.startswith("y_embedder.")])}
    return float(metrics["loss"]), groups


def _t2i_slice_rows(a, b) -> dict:
    (loss, grads), (loss_ref, grads_ref) = a, b
    return {"loss_rel": abs(loss - loss_ref) / abs(loss_ref),
            **{k: _rel_l2(grads[k], grads_ref[k]) for k in grads}}


def calibrate_t2i_train_slice() -> None:
    """The two CPU readings between which the T2I_TRAIN_SLICE_GATES sit."""
    import torch

    fp32 = t2i_train_slice_step("cpu", torch.float32)
    bf16 = t2i_train_slice_step("cpu")
    zero = t2i_train_slice_step("cpu", zero_attention_backward=True)
    emit({"phase": "calibrate_t2i_train_slice", "bf16_vs_fp32": _t2i_slice_rows(bf16, fp32),
          "zero_attention_backward_vs_bf16": _t2i_slice_rows(zero, bf16)})


def phase_t2i_train_slice():
    from deco_tpu_torch.ops import flash_attention as fa

    kernels = (fa.flash_attention_fwd_lse, fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv)
    results = {}
    for device in ("cuda", "cpu"):
        before = [f.launches for f in kernels]
        t0 = time.perf_counter()
        results[device] = t2i_train_slice_step(device)
        results[device + "_s"] = time.perf_counter() - t0
        results[device + "_launches"] = [f.launches - n for f, n in zip(kernels, before)]
    row = _t2i_slice_rows(results["cuda"], results["cpu"])
    emit({"phase": "t2i_train_slice_vs_plain", **T2I_SLICE, "batch": 2, "size": [512, 512],
          "loss": results["cuda"][0], "loss_cpu": results["cpu"][0], **row,
          "limits": T2I_TRAIN_SLICE_GATES, "calibration": T2I_TRAIN_SLICE_READINGS,
          "cuda_launches_fwd_lse_dq_dkv": results["cuda_launches"],
          "cpu_launches": results["cpu_launches"], "cuda_s": results["cuda_s"],
          "cpu_s": results["cpu_s"]})
    check(all(np.isfinite([results["cuda"][0], results["cpu"][0]])), "t2i train slice loss")
    check(results["cuda_launches"] == [3, 3, 3],
          f"t2i train slice launches {results['cuda_launches']}, expected [3, 3, 3]")
    check(results["cpu_launches"] == [0, 0, 0], "the CPU t2i train slice launched a kernel")
    for key, limit in T2I_TRAIN_SLICE_GATES.items():
        check(row[key] < limit, f"t2i train slice {key} {row[key]} >= {limit}")


def write_caption_folder(root: str, seed: int, count: int = 64) -> int:
    """``count`` PNG + caption pairs from ``seed``: non-square images with
    short sides of 512-576 px (so ImageText's bicubic resize and crop are
    real work) and short seeded captions."""
    import os

    from deco_tpu_torch.utils import png

    rng = np.random.default_rng(seed)
    sizes = ((512, 640), (600, 520), (640, 576), (560, 608))  # (H, W)
    words = ("red", "blue", "small", "old", "fox", "cup", "house", "tree", "on", "a", "table",
             "in", "the", "snow", "river", "city")
    os.makedirs(root, exist_ok=True)
    for i in range(count):
        h, w = sizes[i % len(sizes)]
        yy, xx = np.mgrid[0:h, 0:w]
        base = np.stack([xx * 255.0 / w, yy * 255.0 / h, np.full((h, w), 20.0 * (i % 12))], -1)
        image = np.clip(base + rng.normal(0, 25, (h, w, 3)), 0, 255).astype(np.uint8)
        png.write(f"{root}/{i:03d}.png", image)
        with open(f"{root}/{i:03d}.txt", "w") as f:
            f.write("a photo of " + " ".join(rng.choice(words, size=8)))
    return count


def phase_t2i_fit(card: str, seed: int) -> dict:
    """``cli fit -c configs_t2i/sft_res512.yaml`` at full width as shipped
    (DeCo-XXL/16, batch 16 x accumulation 4, no remat) for 3 steps on a
    seeded PNG + caption folder, then ``cli predict`` of one DPG batch of 8
    from the checkpoint it wrote."""
    import json
    import os
    import shutil

    import torch
    from torch.profiler import ProfilerActivity, profile

    from deco_tpu_torch import cli
    from deco_tpu_torch.config import registry
    from deco_tpu_torch.ops import block_dct
    from deco_tpu_torch.ops import flash_attention as fa
    from deco_tpu_torch.train import checkpoint
    from deco_tpu_torch.utils import png
    from deco_tpu_torch.utils.flops import card_peaks

    config = registry.load_yaml(T2I_CONFIG)
    kernels = {"fwd_lse": fa.flash_attention_fwd_lse, "bwd_dq": fa.flash_attention_bwd_dq,
               "bwd_dkv": fa.flash_attention_bwd_dkv, "freq_mse": block_dct.freq_mse,
               "fwd": fa.flash_attention}
    batch = config["data"]["train_batch_size"] * config["trainer"]["accumulate_grad_batches"]
    try:
        images = write_caption_folder(f"{T2I_FIT_DIR}/images", seed)
        workroot = f"{T2I_FIT_DIR}/work"
        for f in kernels.values():
            f.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        # log_every_n_steps=1: a loss read (and so a sync) each step, for the step times
        with Spy(checkpoint.CheckpointManager, "maybe_save") as saves, \
                profile(activities=[ProfilerActivity.CUDA]) as prof:
            state = cli.main(["fit", "-c", T2I_CONFIG,
                              f"--data.train_dataset.init_args.root={T2I_FIT_DIR}/images",
                              f"--trainer.default_root_dir={workroot}",
                              "--max_steps", str(T2I_FIT_STEPS), "--trainer.log_every_n_steps=1"])
        fit_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        launches = {k: f.launches for k, f in kernels.items()}
        model = state.model
        xxl = (len(model.blocks) == 16 and len(model.text_refine_blocks) == 4
               and model.hidden_size == 1536 and model.num_groups == 24
               and not model.grad_checkpoint)
        params = sum(p.numel() for p in model.parameters())
        workdir = f"{workroot}/sftpix512ema"
        records = [json.loads(line) for line in open(f"{workdir}/metrics.jsonl")]
        ends = [r["time"] for r in records]  # each log reads the loss: the end of step k
        step_s = [ends[0]] + [b - a for a, b in zip(ends, ends[1:])]
        s_per_step = float(np.median(step_s[1:]))
        busy_ms = _kernel_busy_ms(prof)
        by_kind = _kernel_ms_by_kind(prof)
        ckpt_path = f"{workdir}/checkpoints/{T2I_FIT_STEPS}.pt"
        written = [c for c in saves.calls if c["out"]]
        names = [n for n, _ in model.named_parameters()]
        obj = torch.load(ckpt_path, map_location="cpu", weights_only=True, mmap=True)
        keys_ok = (set(obj["state_dict"]) == {f"{p}{n}" for p in ("denoiser.", "ema_denoiser.")
                                              for n in names}
                   and set(obj["optimizer"]) == set(names) and obj["step"] == T2I_FIT_STEPS)
        flops = 3 * t2i_flops_per_call(1024) * batch  # forward + backward, remat not counted
        fit = {"phase": "t2i_fit", "config": T2I_CONFIG, "params": params, "images": images,
               "batch": batch, "microbatch": config["data"]["train_batch_size"],
               "grad_checkpoint": model.grad_checkpoint, "steps": T2I_FIT_STEPS,
               "losses": [r["loss"] for r in records], "step_s": step_s,
               "s_per_step": s_per_step, "images_per_s": batch / s_per_step,
               "mfu": flops / s_per_step / card_peaks(card)[0],
               "device_kernel_ms": busy_ms, "kernel_ms_by_kind": by_kind,
               "idle_share": 1 - busy_ms / 1e3 / ends[-1], "peak_mem_bytes": peak,
               "fit_call_s": fit_s, "launches": launches,
               "launches_per_step": {k: v / T2I_FIT_STEPS for k, v in launches.items()},
               "checkpoint_bytes": os.path.getsize(ckpt_path),
               "checkpoint_save_s": [c["seconds"] for c in written],
               "checkpoint_keys_ok": keys_ok, "card": card,
               "note": "timed under torch.profiler (CUDA activity); step_s from metrics.jsonl"}
        emit(fit)
        check(xxl, "the t2i fit did not build DeCo-XXL/16 as shipped (no grad_checkpoint)")
        check(len(records) == T2I_FIT_STEPS and all(np.isfinite(fit["losses"])),
              f"t2i fit losses {records}")
        expected = {k: v * T2I_FIT_STEPS for k, v in T2I_FIT_LAUNCHES.items()}
        check(launches == expected, f"t2i fit launches {launches}, expected {expected}")
        check(keys_ok, "the t2i checkpoint lacks keys")
        check(len(written) == 1, f"{len(written)} checkpoint saves, expected the final one")
        ema_saved = {n[len("ema_denoiser."):]: t for n, t in obj["state_dict"].items()
                     if n.startswith("ema_denoiser.")}
        del obj
        remat = t2i_remat_steps(state, config, card)
        del state, model
        torch.cuda.empty_cache()

        for f in kernels.values():
            f.launches = 0
        t0 = time.perf_counter()
        with Spy(checkpoint.CheckpointManager, "restore_params") as restores:
            cli.main(["predict", "-c", T2I_CONFIG, f"--trainer.default_root_dir={workroot}",
                      f"--ckpt_path={workdir}/checkpoints", "--max_batches", "1"])
        predict_s = time.perf_counter() - t0
        sampling_s = time.perf_counter() - restores.calls[0]["end"]  # after the weights load
        pred_launches = {k: f.launches for k, f in kernels.items()}
        loaded = restores.calls[0]["args"][1]
        ema_equal = all(torch.equal(p.detach().cpu(), ema_saved[n])
                        for n, p in loaded.named_parameters())
        out_dir = f"{workdir}/val_200k/iter_{T2I_FIT_STEPS}"
        files = sorted(os.listdir(out_dir))
        samples = [png.read(os.path.join(out_dir, n)) for n in files]
        want = sorted(f"{p}_{s}.png" for p in ("0", "1") for s in range(4))
        emit({"phase": "t2i_fit_predict", "batch": len(samples), "predict_call_s": predict_s,
              "sampling_s": sampling_s, "images_per_s": len(samples) / sampling_s,
              "launches": pred_launches, "files": files, "ema_loaded_equal": ema_equal,
              "pixel_std": float(np.std(samples)), "card": card})
        check(files == want, f"t2i predict wrote {files}")
        check(all(x.shape == (512, 512, 3) for x in samples), "t2i predict images")
        check(pred_launches["fwd"] == 500 and sum(pred_launches.values()) == 500,
              f"t2i predict launches {pred_launches}, expected 500 forward")
        check(ema_equal, "the predict's weights differ from the saved EMA")
        print(card, flush=True)
        return {"fit": launches, "predict": pred_launches, "remat": remat}
    finally:
        shutil.rmtree(T2I_FIT_DIR, ignore_errors=True)


def t2i_remat_steps(state, config: dict, card: str) -> dict:
    """After the fit: one more step of its model each without and with
    ``grad_checkpoint`` (trunk blocks and decoder res blocks recomputed) on
    one seeded batch of 16 x 4 on the card: step time, peak memory and
    launches, the memory the remat would save and the time it costs."""
    import torch

    from deco_tpu_torch.config import registry
    from deco_tpu_torch.ops import flash_attention as fa
    from deco_tpu_torch.train.train_step import make_train_step

    k = config["trainer"]["accumulate_grad_batches"]
    n = config["data"]["train_batch_size"] * k
    step = make_train_step(registry.instantiate(config["model"]["diffusion_trainer"]),
                           grad_clip=config["trainer"]["gradient_clip_val"],
                           accumulate_grad_batches=k)
    model, rows = state.model, {}
    device = next(model.parameters()).device
    gen = torch.Generator(device=device).manual_seed(5)
    cond = torch.randn(n, model.txt_max_length, model.y_embedder.proj.in_features,
                       generator=gen, device=device) * 0.02
    batch = {"x": torch.rand(n, 512, 512, 3, generator=gen, device=device) * 2 - 1,
             "condition": cond, "uncondition": torch.zeros_like(cond)}
    kernels = (fa.flash_attention_fwd_lse, fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv)
    try:
        for remat in (False, True):
            model.grad_checkpoint = model.dec_net.grad_checkpoint = remat
            before = [f.launches for f in kernels]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            loss = float(step(state, batch, gen)["loss"])
            torch.cuda.synchronize()
            rows["remat" if remat else "none"] = {
                "step_s": time.perf_counter() - t0,
                "peak_mem_bytes": torch.cuda.max_memory_allocated(),
                "launches_fwd_lse_dq_dkv": [f.launches - b for f, b in zip(kernels, before)],
                "loss": loss}
    finally:
        model.grad_checkpoint = model.dec_net.grad_checkpoint = False
    emit({"phase": "t2i_fit_remat", "batch": n, **rows, "card": card})
    check(rows["none"]["launches_fwd_lse_dq_dkv"] == [80, 80, 80]
          and rows["remat"]["launches_fwd_lse_dq_dkv"] == [160, 80, 80],
          f"t2i launches per step without/with remat {rows}")
    check(all(np.isfinite(r["loss"]) for r in rows.values()), "t2i remat step losses")
    return rows


# ---- phase 13: the other c2i families and the REPA objectives ----

FAMILIES_DIR = "build/chip_smoke_c2i_families"  # git-ignored; deleted at the end of the phase
BASELINE_CONFIG = "configs_c2i/Baseline_DiT.yaml"
WEIGHTLESS = "--model.diffusion_trainer.init_args.encoder.init_args.weight_path=null"
# fp32 operands: (B, N, H, D). The DINOv2 tower (D 64): B*H 384 is one
# microbatch of 32 images at 256 px, 1,536 the same repeated by
# diffusion_batch_mul 4, N = 1,025 the tower at 512 px (microbatch 16). The
# DC-AE's DCAttentionBlock (D 32, fp32 by default): 16 and 32 heads over
# 1,024, 256 and 64 tokens at 256 px, 4,096 at 512 px.
F32_SHAPES = {"dinov2_256": (32, 257, 12, 64), "dinov2_256_x4": (128, 257, 12, 64),
              "dinov2_512": (16, 1025, 12, 64), "ragged_17": (2, 17, 3, 64),
              "dcae_1024": (8, 1024, 16, 32), "dcae_256": (8, 256, 32, 32),
              "dcae_64": (8, 64, 32, 32), "dcae_4096": (2, 4096, 16, 32),
              "ragged_17_d32": (2, 17, 3, 32)}
# fp32 kernel vs plain version: both keep P in fp32; the kernel's 3xTF32
# products carry about 2^-22 of relative error each (tests/
# test_torch_fp32_split.py), the plain version's cuBLAS fp32 products
# (TF32 off) less. The error is a few ulps of the output, so 1e-5 x max|v|.
F32_REL = 1e-5
# per step of Baseline_DiT.yaml (batch 32 x diffusion_batch_mul 4, 24 blocks,
# no remat): one forward with lse, dQ and dK/dV per block, and the DINOv2
# tower's 12 layers once per microbatch of 32 images (its features repeated)
BASELINE_FIT_STEPS = 3
BASELINE_LAUNCHES = {"fwd_lse": 24, "bwd_dq": 24, "bwd_dkv": 24, "fwd_f32": 12, "fwd": 0,
                     "freq_mse": 0}
PRETRAINING_CONFIG = "configs_t2i/pretraining_res256.yaml"
# config: (trunk attention blocks run a step, DINOv2 layers run a step,
# grad_checkpoint). As shipped, PixNerd-L, DeCo-L and the t2i pretraining
# step do not fit in the card's 80 GB without remat (--probe-families-memory
# shows both peaks), so they run with the model's grad_checkpoint, which
# recomputes each trunk block: 2 forward-with-lse launches a block.
# DeCo_large.yaml and the pretraining config name DeCoTrainer, which never
# runs its tower: they run with the shipped weight_path (a file the
# repository lacks), their encoder node unbuilt.
FAMILIES = {
    "configs_c2i/Baseline_DiT_JiT.yaml": (24, 12, False),
    "configs_c2i/Baseline_PixNerd.yaml": (22, 12, True),
    "configs_c2i/DeCo_large.yaml": (22, 0, True),
    PRETRAINING_CONFIG: (60, 0, True),  # 3 microbatches x (16 joint + 4 text blocks)
}
REMAT = "--model.denoiser.init_args.grad_checkpoint=true"
# The one-step REPA slice, card vs CPU, both bf16 compute with fp32
# parameters; the tower runs fp32 on both. Gates between the CPU readings of
# --calibrate-c2i-families-slice (bf16 vs fp32; attention backward zeroed),
# set before the first chip run.
FAMILIES_SLICE = {"baseline": dict(num_blocks=2), "pixnerd": dict(num_blocks=3, num_cond_blocks=2,
                                                                  hidden_size_x=64,
                                                                  nerf_mlpratio=2)}
# Readings (CPU): bf16 vs fp32 gives grad rel L2 0.0068 / 0.0072 (baseline /
# pixnerd), the tapped block's 0.0107 / 0.0111, the projection's 0.0027,
# loss 8.9e-5 / 3.4e-5 and cos_loss 1.0e-5 relative; zeroing the attention
# backward moves the gradients by 0.235 / 0.194 and the tapped block's by
# 0.585 / 0.636, and cannot move the loss or the projection's gradient
# (a forward quantity), which are held to ~10x their bf16-vs-fp32 readings.
FAMILIES_SLICE_GATES = {"grad_rel_l2": 0.03, "tapped_rel_l2": 0.05, "proj_rel_l2": 0.02,
                        "loss_rel": 1e-3, "cos_rel": 1e-4}
FAMILIES_SLICE_READINGS = {
    "baseline": {"bf16_vs_fp32": {"grad_rel_l2": 0.00682, "tapped_rel_l2": 0.01074,
                                  "proj_rel_l2": 0.00272, "loss_rel": 8.9e-5, "cos_rel": 1.03e-5},
                 "zero_attention_backward": {"grad_rel_l2": 0.2349, "tapped_rel_l2": 0.5853}},
    "pixnerd": {"bf16_vs_fp32": {"grad_rel_l2": 0.00720, "tapped_rel_l2": 0.01111,
                                 "proj_rel_l2": 0.00272, "loss_rel": 3.4e-5, "cos_rel": 1.03e-5},
                "zero_attention_backward": {"grad_rel_l2": 0.1940, "tapped_rel_l2": 0.6361}}}
# the tower's features, card vs CPU, both fp32 (TF32 off): one layer of fp32
# products in another order
FEATURE_F32_REL = 1e-4


def _f32_operands(gen, b, n, h, d):
    import torch

    return [torch.randn((b, n, h, d), generator=gen, device="cuda") for _ in range(3)]


def _bound_3xtf32(card: str, nbytes: float, flops: float) -> dict:
    """The bound of the fp32 work on the tensor cores as 3xTF32: the larger
    of 3 x ``flops`` at the card's TF32 rate and ``nbytes`` at its memory rate."""
    from deco_tpu_torch.utils.flops import card_peaks, card_tf32_peak

    bound = {"bytes": nbytes / card_peaks(card)[1] * 1e3,
             "operations": 3 * flops / card_tf32_peak(card) * 1e3}
    bound_by = max(bound, key=bound.get)
    return {"bound_3xtf32_ms": bound[bound_by], "bound_3xtf32_by": bound_by}


def phase_fp32_attention(card: str) -> dict:
    """The fp32 forward (DINOv2's attention at D = 64, the DC-AE's at D = 32)
    against its plain version at each shape of F32_SHAPES, bit-identical
    over two runs; timed at every shape but the ragged ones beside both
    bounds (the fp32 SIMT rate; 3xTF32 on the tensor cores), the plain
    version and fp32 SDPA (a yardstick); each instantiation's registers,
    spills and resident CTAs."""
    import torch

    from deco_tpu_torch.ops import _build
    from deco_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(13)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    errs, timings = {}, {}
    for name, (b, n, h, d) in F32_SHAPES.items():
        q, k, v = _f32_operands(gen, b, n, h, d)
        out, again = fa.flash_attention(q, k, v), fa.flash_attention(q, k, v)
        torch.cuda.synchronize()
        ref = fa.flash_attention_plain(q, k, v)
        err, vmax = (out - ref).abs().max().item(), v.abs().max().item()
        errs[name] = err
        emit({"phase": "fp32_attention", "shape": name, "b_n_h_d": [b, n, h, d],
              "max_abs_err": err, "max_abs_v": vmax, "limit": F32_REL * vmax,
              "bit_identical": torch.equal(out, again), "dtype": str(out.dtype)})
        check(out.dtype == torch.float32 and bool(torch.isfinite(out).all()), f"{name}: output")
        check(err <= F32_REL * vmax, f"fp32 attention {name} error {err} > {F32_REL} x {vmax}")
        check(torch.equal(out, again), f"fp32 attention {name} differs between two runs")
        if name.startswith("ragged"):
            continue
        iters = 20 if n > 512 else 30
        nbytes, flops = 4 * 4 * q.numel(), 4 * b * h * n * n * d
        timings[name] = {
            "ms": cuda_ms(lambda: fa.flash_attention_fwd_f32(q, k, v, d ** -0.5), iters, flush),
            "plain_ms": cuda_ms(lambda: fa.flash_attention_plain(q, k, v), max(iters // 5, 3),
                                flush),
            **sdpa_forward_yardsticks(q, k, v, d ** -0.5, False, flush, iters),
            **_bound(card, nbytes, flops, fp32=True), **_bound_3xtf32(card, nbytes, flops),
            "b_n_h_d": [b, n, h, d], "max_abs_err": err, "l2": "flushed before each call",
            "card": card}
        emit({"phase": "fp32_attention", "timing": name, **timings[name]})
        del q, k, v, out, again, ref
    report = _build.ptxas_report((_build.BUILD_DIR / "flash_attention_fwd.log").read_text())
    resources = {}
    for d in fa.F32_HEAD_DIMS:
        ptxas = [r for m, r in report.items() if f"flash_fwd_f32_kernelILi{d}E" in m]
        resources[d] = {"ptxas": ptxas, "runtime": fa.forward_kernel_info(d)["flash_fwd_f32_kernel"]}
        emit({"phase": "fp32_attention", "head_dim": d, "resources": resources[d], "card": card})
        check(len(ptxas) == 1 and ptxas[0]["spill_store_bytes"] == 0
              and resources[d]["runtime"]["local_bytes"] == 0, f"fp32 kernel D = {d} spills")
    for lse in (True, False):
        q, k, v = _f32_operands(gen, 1, 17, 1, 64)
        try:
            if lse:
                fa.flash_attention_fwd_lse(q, k, v, 0.125)
            else:
                fa.flash_attention_bwd(q, k, v, q, torch.zeros(1, 1, 17, device="cuda"), q, 0.125)
            refused = None
        except (TypeError, ValueError) as err:
            refused = str(err)
        emit({"phase": "fp32_attention", "refused": "fwd_lse" if lse else "backward",
              "message": refused})
        check(refused is not None, "an fp32 forward with lse or backward was not refused")
    return {"max_abs_err": max(errs.values()), **timings["dinov2_256"],
            "timings": timings, "resources": resources}


def families_slice_step(family: str, device: str, dtype=None,
                        zero_attention_backward: bool = False):
    """One Baseline_DiT.yaml REPA step (its REPATrainer, AdamW and the
    random DINOv2 cut to 1 layer at full width) of a cut-depth model at full
    width (hidden 1,024, 16 heads of 64), BaselineDiT or PixNerdC2I, at batch
    2 on 256 px, tapped at block 1: (loss, cos_loss, {"all", "proj",
    "tapped": flat gradients of the projection and of block 0}, the tower's
    features), as fp32 tensors on the CPU. Weights, batch and draws come from
    fixed seeds; ``zero_attention_backward`` makes the attention backward
    return zeros (the reading that sets the gates)."""
    import torch

    from deco_tpu_torch.config import registry
    from deco_tpu_torch.models.dit_c2i_baseline import BaselineDiT
    from deco_tpu_torch.models.dit_c2i_deco import init_random_
    from deco_tpu_torch.models.dit_c2i_pixnerd import PixNerdC2I
    from deco_tpu_torch.ops import flash_attention as fa
    from deco_tpu_torch.train.train_step import make_train_step

    config = registry.load_yaml(BASELINE_CONFIG)
    tnode = config["model"]["diffusion_trainer"]
    tnode["init_args"]["encoder"]["init_args"].update(weight_path=None, num_layers=1,
                                                      device=device)
    trainer = registry.instantiate(tnode)
    trainer.align_layer = 1
    trainer.proj_module.to(device).reset_parameters(4)
    cls = BaselineDiT if family == "baseline" else PixNerdC2I
    args = dict(config["model"]["denoiser"]["init_args"], **FAMILIES_SLICE[family])
    model = init_random_(cls(**args, dtype=dtype or torch.bfloat16, param_dtype=torch.float32,
                             align_layer=1, device=device), seed=1)
    state = registry.instantiate(config["model"]["optimizer"]).create_state(
        model.train(), trainer_module=trainer.proj_module)
    step = make_train_step(trainer, grad_clip=None)
    rng = np.random.default_rng(2)
    x = rng.uniform(-1, 1, (2, 256, 256, 3)).astype(np.float32)
    batch = {"x": torch.from_numpy(x).to(device), "condition": torch.tensor([3, 7], device=device),
             "uncondition": torch.tensor([1000, 1000], device=device),
             "metadata": {"raw_image": torch.from_numpy((x + 1) / 2).to(device)}}
    draws = dict(drop_u=np.array([0.9, 0.05], np.float32),  # p = 0.1: the second row dropped
                 t_normal=rng.standard_normal(2).astype(np.float32),
                 noise=rng.standard_normal((2, 256, 256, 3)).astype(np.float32))
    with torch.no_grad():
        features = trainer.encoder(batch["metadata"]["raw_image"]).float().cpu()
    saved = fa.flash_attention_bwd
    if zero_attention_backward:
        fa.flash_attention_bwd = lambda q, k, v, *_: tuple(map(torch.zeros_like, (q, k, v)))
    try:
        metrics = step(state, batch, draws=[draws])
    finally:
        fa.flash_attention_bwd = saved
    named = [(n, p.grad.reshape(-1).float().cpu()) for n, p in state.named_parameters()]
    groups = {"all": torch.cat([g for _, g in named]),
              "proj": torch.cat([g for n, g in named if n.startswith("diffusion_trainer.")]),
              "tapped": torch.cat([g for n, g in named if n.startswith("blocks.0.")])}
    return float(metrics["loss"]), float(metrics["cos_loss"]), groups, features


def _families_rows(a, b) -> dict:
    (loss, cos, grads, _), (loss_ref, cos_ref, grads_ref, _) = a, b
    return {"loss_rel": abs(loss - loss_ref) / abs(loss_ref),
            "cos_rel": abs(cos - cos_ref) / abs(cos_ref),
            "grad_rel_l2": _rel_l2(grads["all"], grads_ref["all"]),
            "proj_rel_l2": _rel_l2(grads["proj"], grads_ref["proj"]),
            "tapped_rel_l2": _rel_l2(grads["tapped"], grads_ref["tapped"])}


def calibrate_families_slice() -> None:
    """The CPU readings between which FAMILIES_SLICE_GATES sit."""
    import torch

    for family in FAMILIES_SLICE:
        fp32 = families_slice_step(family, "cpu", torch.float32)
        bf16 = families_slice_step(family, "cpu")
        zero = families_slice_step(family, "cpu", zero_attention_backward=True)
        emit({"phase": "calibrate_c2i_families_slice", "family": family,
              "bf16_vs_fp32": _families_rows(bf16, fp32),
              "zero_attention_backward_vs_bf16": _families_rows(zero, bf16)})


def phase_families_slice():
    """The REPA step of each family, card against CPU."""
    from deco_tpu_torch.ops import flash_attention as fa

    kernels = (fa.flash_attention_fwd_lse, fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv,
               fa.flash_attention_fwd_f32)
    for family in FAMILIES_SLICE:
        results = {}
        for device in ("cuda", "cpu"):
            before = [f.launches for f in kernels]
            t0 = time.perf_counter()
            results[device] = families_slice_step(family, device)
            results[device + "_s"] = time.perf_counter() - t0
            results[device + "_launches"] = [f.launches - n for f, n in zip(kernels, before)]
        row = _families_rows(results["cuda"], results["cpu"])
        features, features_ref = results["cuda"][3], results["cpu"][3]
        row["feature_rel_l2"] = _rel_l2(features, features_ref)
        trunk = FAMILIES_SLICE[family].get("num_cond_blocks", FAMILIES_SLICE[family]["num_blocks"])
        emit({"phase": "c2i_families_slice_vs_plain", "family": family, **FAMILIES_SLICE[family],
              "batch": 2, "size": 256, "tower_layers": 1, "loss": results["cuda"][0],
              "loss_cpu": results["cpu"][0], "cos_loss": results["cuda"][1],
              "cos_loss_cpu": results["cpu"][1], **row, "limits": FAMILIES_SLICE_GATES,
              "feature_limit": FEATURE_F32_REL, "calibration": FAMILIES_SLICE_READINGS.get(family),
              "cuda_launches_fwd_lse_dq_dkv_f32": results["cuda_launches"],
              "cpu_launches": results["cpu_launches"], "cuda_s": results["cuda_s"],
              "cpu_s": results["cpu_s"]})
        check(all(np.isfinite([results["cuda"][0], results["cuda"][1]])), f"{family} slice loss")
        # the encode in the slice itself and the one inside the step: 2 tower calls
        check(results["cuda_launches"] == [trunk, trunk, trunk, 2],
              f"{family} slice launches {results['cuda_launches']}")
        check(results["cpu_launches"] == [0, 0, 0, 0], f"the CPU {family} slice launched a kernel")
        check(row["feature_rel_l2"] < FEATURE_F32_REL, f"{family} tower features {row}")
        for key, limit in FAMILIES_SLICE_GATES.items():
            check(row[key] < limit, f"{family} slice {key} {row[key]} >= {limit}")


def _fit_kernels():
    from deco_tpu_torch.ops import block_dct
    from deco_tpu_torch.ops import flash_attention as fa

    return {"fwd_lse": fa.flash_attention_fwd_lse, "bwd_dq": fa.flash_attention_bwd_dq,
            "bwd_dkv": fa.flash_attention_bwd_dkv, "fwd_f32": fa.flash_attention_fwd_f32,
            "fwd": fa.flash_attention, "freq_mse": block_dct.freq_mse}


def _fit_records(workdir: str) -> tuple:
    import json

    records = [json.loads(line) for line in open(f"{workdir}/metrics.jsonl")]
    ends = [r["time"] for r in records]  # each log reads the loss: the end of step k
    return records, ends, [ends[0]] + [b - a for a, b in zip(ends, ends[1:])]


def phase_baseline_fit(card: str, seed: int) -> dict:
    """``cli fit -c configs_c2i/Baseline_DiT.yaml`` as shipped (Baseline-
    DiT-L/16, REPA with the random DINOv2, batch 32 x diffusion_batch_mul 4,
    no remat) but for the folder, the work directory, the steps and the
    tower's weights, then ``cli predict`` of 32 images from its checkpoint."""
    import os
    import shutil

    import torch
    from torch.profiler import ProfilerActivity, profile

    from deco_tpu_torch import cli
    from deco_tpu_torch.config import registry
    from deco_tpu_torch.train import checkpoint
    from deco_tpu_torch.utils.flops import baseline_dit_flops, card_peaks, vit_flops

    config = registry.load_yaml(BASELINE_CONFIG)
    kernels = _fit_kernels()
    steps = BASELINE_FIT_STEPS
    try:
        images = write_image_folder(f"{FAMILIES_DIR}/images", seed)
        workroot = f"{FAMILIES_DIR}/work"
        for f in kernels.values():
            f.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with Spy(checkpoint.CheckpointManager, "maybe_save") as saves, \
                profile(activities=[ProfilerActivity.CUDA]) as prof:
            state = cli.main(["fit", "-c", BASELINE_CONFIG, WEIGHTLESS,
                              f"--data.train_dataset.init_args.root={FAMILIES_DIR}/images",
                              f"--trainer.default_root_dir={workroot}", "--max_steps", str(steps),
                              "--trainer.log_every_n_steps=1"])
        fit_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        launches = {k: f.launches for k, f in kernels.items()}
        model = state.model
        large = (len(model.blocks) == 24 and model.hidden_size == 1024 and model.num_groups == 16
                 and not model.grad_checkpoint and model.align_layer == 8)
        workdir = f"{workroot}/Baseline_repa_large"
        records, ends, step_s = _fit_records(workdir)
        s_per_step = float(np.median(step_s[1:]))
        busy_ms = _kernel_busy_ms(prof)
        rows = config["data"]["train_batch_size"] * 4  # diffusion_batch_mul 4 (the default)
        flops = 3 * baseline_dit_flops() * rows + vit_flops() * config["data"]["train_batch_size"]
        ckpt_path = f"{workdir}/checkpoints/{steps}.pt"
        written = [c for c in saves.calls if c["out"]]
        obj = torch.load(ckpt_path, map_location="cpu", weights_only=True, mmap=True)
        proj_keys = sorted(k for k in obj["state_dict"] if "diffusion_trainer." in k)
        fit = {"phase": "baseline_fit", "config": BASELINE_CONFIG, "images": images,
               "batch": config["data"]["train_batch_size"], "rows_per_step": rows,
               "steps": steps, "losses": [r["loss"] for r in records],
               "fm_losses": [r["fm_loss"] for r in records],
               "cos_losses": [r["cos_loss"] for r in records], "step_s": step_s,
               "s_per_step": s_per_step, "images_per_s": config["data"]["train_batch_size"]
               / s_per_step, "mfu": flops / s_per_step / card_peaks(card)[0],
               "flops_per_step": flops, "device_kernel_ms": busy_ms,
               "kernel_ms_by_kind": _kernel_ms_by_kind(prof),
               "idle_share": 1 - busy_ms / 1e3 / ends[-1], "peak_mem_bytes": peak,
               "fit_call_s": fit_s, "launches": launches,
               "launches_per_step": {k: v / steps for k, v in launches.items()},
               "checkpoint_bytes": os.path.getsize(ckpt_path),
               "checkpoint_save_s": [c["seconds"] for c in written], "proj_keys": proj_keys,
               "params": sum(p.numel() for p in model.parameters()), "card": card,
               "note": "timed under torch.profiler (CUDA activity); step_s from metrics.jsonl"}
        emit(fit)
        check(large, "the fit did not build Baseline-DiT-L/16 as shipped, tapped at block 8")
        check(len(records) == steps and all(np.isfinite(fit["fm_losses"] + fit["cos_losses"])),
              f"baseline fit losses {records}")
        check(min(fit["cos_losses"]) > 1e-4, f"the REPA term is zero: {fit['cos_losses']}")
        expected = {k: v * steps for k, v in BASELINE_LAUNCHES.items()}
        check(launches == expected, f"baseline fit launches {launches}, expected {expected}")
        check(len(proj_keys) == 12 and len(written) == 1, f"checkpoint {proj_keys} {written}")
        ema_saved = {n[len("ema_denoiser."):]: t for n, t in obj["state_dict"].items()
                     if n.startswith("ema_denoiser.")}
        del obj, state, model
        torch.cuda.empty_cache()

        for f in kernels.values():
            f.launches = 0
        t0 = time.perf_counter()
        with Spy(checkpoint.CheckpointManager, "restore_params") as restores:
            out = cli.main(["predict", "-c", BASELINE_CONFIG, WEIGHTLESS,
                            f"--trainer.default_root_dir={workroot}",
                            f"--ckpt_path={workdir}/checkpoints", "--max_batches", "1"])
        predict_s = time.perf_counter() - t0
        sampling_s = time.perf_counter() - restores.calls[0]["end"]
        pred_launches = {k: f.launches for k, f in kernels.items()}
        loaded = restores.calls[0]["args"][1]
        ema_equal = all(torch.equal(p.detach().cpu(), ema_saved[n])
                        for n, p in loaded.named_parameters())
        arr = np.load(out)["arr_0"]
        emit({"phase": "baseline_fit_predict", "batch": int(arr.shape[0]),
              "steps": config["model"]["diffusion_sampler"]["init_args"]["num_steps"],
              "predict_call_s": predict_s, "sampling_s": sampling_s,
              "images_per_s": arr.shape[0] / sampling_s, "launches": pred_launches,
              "npz_shape": list(arr.shape), "pixel_std": float(arr.std()),
              "ema_loaded_equal": ema_equal, "card": card})
        check(arr.shape == (32, 256, 256, 3) and arr.std() > 0, f"npz {arr.shape}")
        check(pred_launches["fwd"] == 1200 and sum(pred_launches.values()) == 1200,
              f"baseline predict launches {pred_launches}, expected 1200 forward")
        check(ema_equal, "the predict's weights differ from the saved EMA")
        return {"fit": launches, "predict": pred_launches}
    finally:
        shutil.rmtree(FAMILIES_DIR, ignore_errors=True)


def write_tar_shard(path: str, seed: int, count: int = 64) -> int:
    """A webdataset tar of ``count`` seeded PNG + caption members, 256-320 px."""
    import io
    import os
    import tarfile

    from deco_tpu_torch.utils import png

    rng = np.random.default_rng(seed)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with tarfile.open(path, "w") as tf:
        for i in range(count):
            h, w = (256, 320) if i % 2 else (288, 256)
            image = rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
            for name, data in ((f"{i:05d}.png", png.encode(image)),
                               (f"{i:05d}.txt", f"a photo of thing {i}".encode())):
                info = tarfile.TarInfo(name)
                info.size = len(data)
                tf.addfile(info, io.BytesIO(data))
    return count


def _families_runs() -> list:
    """(config, its data override) of the one-step fits of phase 13."""
    return [(path, f"--data.train_dataset.init_args.urls={FAMILIES_DIR}/shards"
             if path == PRETRAINING_CONFIG else
             f"--data.train_dataset.init_args.root={FAMILIES_DIR}/images") for path in FAMILIES]


def _one_step_fit(path: str, data_arg: str, remat: bool):
    """``cli fit`` of one step of ``path`` on the phase's data, without the
    final checkpoint (the script's 45 GiB disk-write budget: it is not what these fits
    check), with a random tower where the trainer runs one and the shipped
    weight_path where it does not; returns (train state, the Experiment, seconds)."""
    import torch

    from deco_tpu_torch import cli
    from deco_tpu_torch.train import checkpoint, loop

    name = path.rsplit("/", 1)[1][:-5] + ("_remat" if remat else "")
    t0 = time.perf_counter()
    with Spy(loop.Experiment, "fit") as fits, \
            Spy(checkpoint.CheckpointManager, "save", replace=lambda self, obj, step: None):
        state = cli.main(["fit", "-c", path, *([WEIGHTLESS] if FAMILIES[path][1] else []),
                          data_arg, *([REMAT] if remat else []),
                          f"--trainer.default_root_dir={FAMILIES_DIR}/work", "--max_steps", "1",
                          "--trainer.log_every_n_steps=1", f"--tags.exp={name}"])
    torch.cuda.synchronize()
    return state, fits.calls[0]["args"][0], time.perf_counter() - t0


def phase_families_fit(card: str, seed: int) -> dict:
    """One ``cli fit`` step each of Baseline_DiT_JiT.yaml, Baseline_PixNerd.yaml
    and DeCo_large.yaml as shipped (but for the folder, the work directory,
    the steps, the tower's weights where the trainer runs it and, where the
    step does not fit, the model's grad_checkpoint), then of
    pretraining_res256.yaml from a tar shard. The DeCoTrainer configs keep
    the shipped weight_path, which names a file the repository lacks: their
    encoder node stays unbuilt, so no DINOv2 parameter reaches the card."""
    import shutil

    import torch

    from deco_tpu_torch.config import registry

    kernels = _fit_kernels()
    out = {}
    try:
        write_image_folder(f"{FAMILIES_DIR}/images", seed)
        write_tar_shard(f"{FAMILIES_DIR}/shards/00000.tar", seed)
        for path, data_arg in _families_runs():
            blocks, tower, remat = FAMILIES[path]
            for f in kernels.values():
                f.launches = 0
            torch.cuda.reset_peak_memory_stats()
            state, exp, seconds = _one_step_fit(path, data_arg, remat)
            launches = {k: f.launches for k, f in kernels.items()}
            records, _, _ = _fit_records(exp.workdir)
            emit({"phase": "families_fit", "config": path, "grad_checkpoint": remat,
                  "records": records, "launches": launches, "fit_call_s": seconds,
                  "peak_mem_bytes": torch.cuda.max_memory_allocated(),
                  "model": type(state.model).__name__, "trainer": type(exp.trainer).__name__,
                  "encoder": type(exp.trainer.encoder).__name__,
                  "encoder_built": getattr(exp.trainer.encoder, "built", True) is not None,
                  "params": sum(p.numel() for p in state.model.parameters()),
                  "trainer_params": 0 if state.trainer_module is None else sum(
                      p.numel() for p in state.trainer_module.parameters()), "card": card})
            check(len(records) == 1 and np.isfinite(records[0]["fm_loss"]), f"{path}: {records}")
            if tower:
                check(type(exp.trainer.encoder).__name__ == "DINOv2", f"{path}: no DINOv2 tower")
            else:
                enc = exp.trainer.encoder
                check(isinstance(enc, registry.Deferred) and enc.built is None
                      and enc.node["init_args"]["weight_path"].endswith(
                          "dinov2_vitb14_pretrain.pth"),
                      f"{path}: the DINOv2 node was built or its weight_path overridden")
            want = {"fwd_lse": blocks * (2 if remat else 1), "bwd_dq": blocks, "bwd_dkv": blocks,
                    "fwd_f32": tower, "fwd": 0, "freq_mse": 0}
            check(launches == want, f"{path} launches {launches}, expected {want}")
            if tower:
                check(records[0]["cos_loss"] > 1e-4, f"{path}: the REPA term is zero")
            out[path] = launches
            del state, exp
            torch.cuda.empty_cache()
        return out
    finally:
        shutil.rmtree(FAMILIES_DIR, ignore_errors=True)


def probe_families_memory(seed: int) -> None:
    """On the card, not a phase: the peak memory of one step of each
    family config without and with grad_checkpoint, an out-of-memory
    error reported as such (what FAMILIES's remat choices rest on)."""
    import gc
    import shutil

    import torch

    card = phase_build()
    try:
        write_image_folder(f"{FAMILIES_DIR}/images", seed)
        write_tar_shard(f"{FAMILIES_DIR}/shards/00000.tar", seed)
        for path, data_arg in _families_runs():
            for remat in (False, True):
                torch.cuda.reset_peak_memory_stats()
                try:
                    _one_step_fit(path, data_arg, remat)
                    result = "fits"
                except torch.cuda.OutOfMemoryError:
                    result = "out of memory"
                emit({"probe": "families_memory", "config": path, "grad_checkpoint": remat,
                      "result": result, "peak_mem_bytes": torch.cuda.max_memory_allocated(),
                      "card": card})
                gc.collect()
                torch.cuda.empty_cache()
    finally:
        shutil.rmtree(FAMILIES_DIR, ignore_errors=True)

RECO_CONFIG = "configs_c2i/ReCo_large.yaml"
RECO_448_CONFIG = "configs_c2i/ReCo_large_stage3.yaml"
RECO_DIR = "build/chip_smoke_reco"  # git-ignored; deleted at the end of the phase
# (B, Nq, Nkv, H, D): the InternViT tower (16^2 + 1 tokens) and the decoder
# blocks (16 learnable + 256 latent tokens) at the shipped fit batch 16 x 4 at
# 224 px, and at 448 px (32^2 + 1, 16 + 1,024) at 16 rows
RECO_SHAPES = {"tower_224": (64, 257, 257, 16, 64), "decoder_224": (64, 272, 272, 16, 64),
               "tower_448": (16, 1025, 1025, 16, 64), "decoder_448": (16, 1040, 1040, 16, 64)}
RECO_FIT_STEPS = 3
# per step at batch 16 x diffusion_batch_mul 4: 24 tower layers + 6 decoder blocks
RECO_LAYERS = 30
RECO_SAMPLER_STEPS = 100
# The ReCo slice: full width and depth (ReCo_large.yaml), batch 2 at 224 px,
# one forward and one DeCoTrainer loss gradient with fixed draws, the
# attention kernels against the plain version on the card, both bf16 with
# fp32 parameters. The gates sit between the CPU readings of
# --calibrate-reco-slice (bf16 vs fp32 compute, and the attention zeroed vs
# bf16; RECO_SLICE_READINGS), set before the first card run; kernel vs plain
# changes only the attention's roundings (P to bf16 against the running
# maximum), so it should read under bf16 vs fp32: each gate is 2x that
# reading, and a zeroed attention reads 10-20x over it. The loss, which the
# attention hardly moves at random weights (the zeroed reading is under the
# bf16 one), is held to 10x its bf16-vs-fp32 reading. Parameters drawn by
# init_random_ (no zero final layer, so every parameter gets a gradient).
RECO_SLICE_GATES = {"out_rel_l2": 0.042, "loss_rel": 4e-3, "grad_rel_l2": 0.025,
                    "tower_grad_rel_l2": 0.093}
RECO_SLICE_READINGS = {
    "bf16_vs_fp32": {"out_rel_l2": 0.0211, "loss_rel": 3.9e-4, "grad_rel_l2": 0.0123,
                     "tower_grad_rel_l2": 0.0465},
    "zero_attention_vs_bf16": {"out_rel_l2": 0.389, "loss_rel": 1.2e-4, "grad_rel_l2": 0.325,
                               "tower_grad_rel_l2": 0.753}}


def _reco_denoiser(device: str, dtype: str = "bfloat16"):
    """ReCo_large.yaml's denoiser, fp32 parameters drawn from seed 0 with no
    parameter zero (``init_random_``: the JAX initializers zero the final
    linear, and nothing upstream of it would then get a gradient)."""
    from deco_tpu_torch.config import registry
    from deco_tpu_torch.models.dit_c2i_deco import init_random_

    node = registry.load_yaml(RECO_CONFIG)["model"]["denoiser"]
    model = registry.instantiate({**node, "init_args": {
        **node["init_args"], "dtype": dtype, "param_dtype": "float32", "device": device}})
    return init_random_(model, 0)


def reco_slice_step(device: str, dtype: str = "bfloat16", attention: str = "kernel") -> dict:
    """One forward and one loss gradient of the full-width ReCo at batch 2
    (224 px) with fixed inputs and draws: the output, the loss, all
    gradients and the tower's, on the CPU in fp32. ``attention`` "plain"
    runs every attention through the plain version (autograd), "zero"
    gives zeros (the calibration's yardstick)."""
    import torch

    from deco_tpu_torch.diffusion.scheduling import LinearScheduler
    from deco_tpu_torch.diffusion.training import DeCoTrainer
    from deco_tpu_torch.models import layers
    from deco_tpu_torch.ops import flash_attention as fa

    model = _reco_denoiser(device, dtype)
    rng = np.random.default_rng(5)
    image, x_t, noise = (torch.from_numpy(a.astype(np.float32)).to(device) for a in (
        rng.uniform(-1, 1, (2, 224, 224, 3)), rng.standard_normal((2, 224, 224, 3)),
        rng.standard_normal((2, 224, 224, 3))))
    draws = dict(t_normal=np.array([0.4, -1.1], np.float32),
                 t_uniform=np.array([0.25, 0.8], np.float32),
                 mix_u=np.array([0.2, 0.95], np.float32), noise=noise)
    trainer = DeCoTrainer(LinearScheduler(), lognorm_t=True, null_condition_p=0.0)
    cond = image.to(torch.bfloat16)
    kernel = layers.flash_attention
    if attention == "plain":
        layers.flash_attention = lambda q, k, v, scale=None, causal=False: (
            fa.flash_attention_plain(q, k, v, scale, causal=causal))
    elif attention == "zero":
        layers.flash_attention = lambda q, k, v, scale=None, causal=False: torch.zeros_like(q)
    try:
        with torch.no_grad():
            out = model(x_t, torch.tensor([0.3, 0.7], device=device), cond)
        loss = trainer(model, image, cond, torch.zeros_like(cond), draws=draws)["loss"]
        loss.backward()
    finally:
        layers.flash_attention = kernel

    def flat(params):  # a parameter the loss does not reach (mlp1) counts as zeros
        return torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).float()
                          .reshape(-1).cpu() for p in params])

    return {"out": out.float().cpu(), "loss": float(loss.detach()),
            "grads": flat(model.parameters()),
            "tower_grads": flat(model.vision_model.parameters())}


def _reco_slice_rows(a: dict, b: dict) -> dict:
    """Each reading of ``a`` against ``b``: relative L2 of the output and the
    gradients, relative difference of the loss."""
    return {"out_rel_l2": _rel_l2(a["out"], b["out"]),
            "loss_rel": abs(a["loss"] - b["loss"]) / abs(b["loss"]),
            "grad_rel_l2": _rel_l2(a["grads"], b["grads"]),
            "tower_grad_rel_l2": _rel_l2(a["tower_grads"], b["tower_grads"])}


def calibrate_reco_slice() -> None:
    """On the CPU: the readings between which RECO_SLICE_GATES sit."""
    bf16 = reco_slice_step("cpu")
    print(json.dumps({"bf16_vs_fp32": _reco_slice_rows(bf16, reco_slice_step("cpu", "float32")),
                      "zero_attention_vs_bf16": _reco_slice_rows(
                          reco_slice_step("cpu", attention="zero"), bf16)}))


def phase_reco_kernels(card: str) -> dict:
    """Rows 1, 3, 5 and 6 at the ReCo shapes against their plain versions
    (the forward and the forward with lse bit-identical over two runs, the
    backward too), then timed beside the bound, the plain versions and the
    SDPA yardsticks."""
    import torch

    from deco_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(14)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")  # > the 50 MB L2
    errs = {"fwd": 0.0, "fwd_lse": 0.0, "bwd_dq": 0.0, "bwd_dkv": 0.0}
    timings: dict = {key: {} for key in errs}
    for name, shape in RECO_SHAPES.items():
        b, nq, nkv, h, d = shape
        q, k, v, do = attention_operands(gen, *shape)
        out, again = fa.flash_attention(q, k, v), fa.flash_attention(q, k, v)
        torch.cuda.synchronize()
        err = (out.float() - fa.flash_attention_plain(q, k, v).float()).abs().max().item()
        check(bool(torch.isfinite(out).all()) and err < ATTN_ATOL,
              f"reco attention {name} error {err} >= {ATTN_ATOL}")
        check(torch.equal(out, again), f"reco attention {name} differs between two runs")
        errs["fwd"] = max(errs["fwd"], err)
        timings["fwd"][name] = {
            "b_nq_nkv_h_d": list(shape), "max_abs_err": err,
            "ms": cuda_ms(lambda: fa.flash_attention(q, k, v), 30, flush),
            "plain_ms": cuda_ms(lambda: fa.flash_attention_plain(q, k, v), 5, flush),
            **sdpa_forward_yardsticks(q, k, v, d ** -0.5, False, flush, 30),
            **_bound(card, 2 * (2 * q.numel() + k.numel() + v.numel()),
                     4 * b * h * nq * nkv * d)}
        emit({"phase": "reco_kernels", "timing": f"fwd_{name}", **timings["fwd"][name],
              "atol": ATTN_ATOL, "bit_identical": True, "l2": "flushed before each call",
              "card": card})
        row = hold_attention_training("reco_kernels", name, shape, (q, k, v, do))
        for key, value in row["errs"].items():
            errs[key] = max(errs[key], value)
        for kernel, timing in _attention_timings(card, (q, k, v, do), flush, 20).items():
            timings[kernel][name] = {"b_nq_nkv_h_d": list(shape), **timing}
            emit({"phase": "reco_kernels", "timing": f"{kernel}_{name}", **timings[kernel][name],
                  "l2": "flushed before each call", "card": card})
        del q, k, v, do, out, again
    return {"errs": errs, "timings": timings}


def phase_reco_slice() -> dict:
    """The full-width ReCo on the card, kernels against the plain attention."""
    import torch

    from deco_tpu_torch.ops import flash_attention as fa

    kernels = (fa.flash_attention, fa.flash_attention_fwd_lse, fa.flash_attention_bwd_dq,
               fa.flash_attention_bwd_dkv)
    for f in kernels:
        f.launches = 0
    kernel = reco_slice_step("cuda")
    launches = [f.launches for f in kernels]
    torch.cuda.empty_cache()
    plain = reco_slice_step("cuda", attention="plain")
    plain_launches = [f.launches for f in kernels]
    torch.cuda.empty_cache()
    row = _reco_slice_rows(kernel, plain)
    emit({"phase": "reco_slice_vs_plain", "config": RECO_CONFIG, "batch": 2, "image_size": 224,
          **row, "gates": RECO_SLICE_GATES, "cpu_readings": RECO_SLICE_READINGS,
          "loss": kernel["loss"], "plain_loss": plain["loss"], "launches": launches,
          "params_with_grad": int(kernel["grads"].numel())})
    check(np.isfinite(kernel["loss"]) and bool(torch.isfinite(kernel["out"]).all()),
          "reco slice: not finite")
    check(launches == [RECO_LAYERS] * 4, f"reco slice launches {launches}, expected "
                                         f"{RECO_LAYERS} of each kernel")
    check(plain_launches == launches, "the plain ReCo slice launched a kernel")
    for key, limit in RECO_SLICE_GATES.items():
        check(row[key] < limit, f"reco slice {key} {row[key]} >= {limit}")
    return row


def _write_reco_config(path: str, config_path: str, train_root: str, eval_root: str,
                       workroot: str) -> dict:
    """``config_path`` as shipped but for its data nodes, which read PNG
    folders through PixImageNet at the config's resolution (the card host
    has no ``datasets`` for PixHFDataset), its work directory and a log line
    every step; written to ``path``."""
    from deco_tpu_torch.config import _yaml, registry

    config = registry.load_yaml(config_path)
    for key, root in (("train_dataset", train_root), ("eval_dataset", eval_root)):
        node = config["data"][key]
        check(node["class_path"].endswith("PixHFDataset"), f"{config_path} {key} changed")
        config["data"][key] = {"class_path": "src.data.dataset.imagenet.PixImageNet",
                               "init_args": {"root": root,
                                             "resolution": node["init_args"]["resolution"]}}
    config["trainer"].update(default_root_dir=workroot, log_every_n_steps=1)
    with open(path, "w") as f:
        f.write(_yaml.dump(config))
    return config


def phase_reco(card: str, seed: int) -> dict:
    """ReCo through the CLI as users run it: ``cli fit`` on ReCo_large.yaml
    (3 steps, batch 16 x 4, its W&B node kept), ``cli validate`` from the
    checkpoint (one batch of 32, 100 Euler steps), then one step of
    ReCo_large_stage3.yaml at 448 px for its peak memory."""
    import importlib.util
    import json
    import os
    import shutil

    import torch
    from torch.profiler import ProfilerActivity, profile

    from deco_tpu_torch import cli
    from deco_tpu_torch.train import checkpoint
    from deco_tpu_torch.utils.flops import card_peaks, reco_flops

    kernels = _fit_kernels()
    # the configs keep their WandbLogger node: without wandb the gate keeps
    # the JSONL log; with it, no run may reach for the network
    has_wandb = importlib.util.find_spec("wandb") is not None
    os.environ.setdefault("WANDB_MODE", "disabled")
    has_datasets = importlib.util.find_spec("datasets") is not None
    try:
        images = write_image_folder(f"{RECO_DIR}/train", seed)
        evals = write_image_folder(f"{RECO_DIR}/eval", seed + 1, per_class=16)
        workroot = f"{RECO_DIR}/work"
        path = f"{RECO_DIR}/ReCo_large.yaml"
        config = _write_reco_config(path, RECO_CONFIG, f"{RECO_DIR}/train", f"{RECO_DIR}/eval",
                                    workroot)
        batch, mul = config["data"]["train_batch_size"], config["model"]["diffusion_batch_mul"]
        for f in kernels.values():
            f.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with Spy(checkpoint.CheckpointManager, "maybe_save") as saves, \
                profile(activities=[ProfilerActivity.CUDA]) as prof:
            state = cli.main(["fit", "-c", path, "--max_steps", str(RECO_FIT_STEPS)])
        fit_s = time.perf_counter() - t0
        launches = {k: f.launches for k, f in kernels.items()}
        peak = torch.cuda.max_memory_allocated()
        model = state.model
        workdir = f"{workroot}/{config['tags']['exp']}"
        records, ends, step_s = _fit_records(workdir)
        s_per_step = float(np.median(step_s[1:]))
        busy_ms = _kernel_busy_ms(prof)
        flops = 3 * reco_flops() * batch * mul
        written = [c for c in saves.calls if c["out"]]
        ckpt_path = f"{workdir}/checkpoints/{RECO_FIT_STEPS}.pt"
        fit = {"phase": "reco_fit", "config": RECO_CONFIG, "images": images,
               "data": "PixImageNet over a seeded PNG folder (datasets is "
                       + ("importable" if has_datasets else "absent") + " on this host)",
               "wandb": "importable (WANDB_MODE=disabled)" if has_wandb else "absent: JSONL only",
               "batch": batch, "diffusion_batch_mul": mul, "steps": RECO_FIT_STEPS,
               "losses": [r["loss"] for r in records], "grad_norms": [r["grad_norm"]
                                                                      for r in records],
               "step_s": step_s, "s_per_step": s_per_step, "images_per_s": batch / s_per_step,
               "mfu": flops / s_per_step / card_peaks(card)[0], "flops_per_step": flops,
               "device_kernel_ms": busy_ms, "kernel_ms_by_kind": _kernel_ms_by_kind(prof),
               "idle_share": 1 - busy_ms / 1e3 / ends[-1], "peak_mem_bytes": peak,
               "fit_call_s": fit_s, "launches": launches,
               "launches_per_step": {k: v / RECO_FIT_STEPS for k, v in launches.items()},
               "checkpoint_bytes": os.path.getsize(ckpt_path),
               "checkpoint_save_s": [c["seconds"] for c in written],
               "params": sum(p.numel() for p in model.parameters()), "card": card,
               "note": "timed under torch.profiler (CUDA activity); step_s from metrics.jsonl"}
        emit(fit)
        check(type(model).__name__ == "ReCoModel" and len(model.vision_model.encoder.layers) == 24
              and len(model.pixel_decoder.blocks) == 6 and model.pixel_decoder.hidden_size == 1024
              and model.dtype == torch.bfloat16, "the fit did not build ReCo_large.yaml's model")
        check(len(records) == RECO_FIT_STEPS and all(np.isfinite(fit["losses"])),
              f"reco fit losses {records}")
        expected = {k: 0 for k in launches}
        expected.update({k: RECO_LAYERS * RECO_FIT_STEPS for k in ("fwd_lse", "bwd_dq",
                                                                   "bwd_dkv")})
        check(launches == expected, f"reco fit launches {launches}, expected {expected}")
        check(len(written) == 1, f"{len(written)} checkpoint saves, expected the final one")
        del state, model
        torch.cuda.empty_cache()

        for f in kernels.values():
            f.launches = 0
        t0 = time.perf_counter()
        with Spy(checkpoint.CheckpointManager, "restore_params") as restores:
            cli.main(["validate", "-c", path, f"--ckpt_path={workdir}/checkpoints",
                      "--max_batches", "1"])
        validate_s = time.perf_counter() - t0
        sampling_s = time.perf_counter() - restores.calls[0]["end"]
        val_launches = {k: f.launches for k, f in kernels.items()}
        scores = json.load(open(f"{workdir}/predict_metrics.json"))
        panels = sorted(os.listdir(f"{workdir}/images"))
        pred_batch = config["data"]["pred_batch_size"]
        want = RECO_LAYERS * RECO_SAMPLER_STEPS  # guidance 1.0: one conditional call a step
        emit({"phase": "reco_validate", "config": RECO_CONFIG, "eval_images": evals,
              "batch": pred_batch, "sampler_steps": RECO_SAMPLER_STEPS,
              "validate_call_s": validate_s, "sampling_s": sampling_s,
              "images_per_s": pred_batch / sampling_s, "launches": val_launches,
              "scores": scores, "side_by_side_panels": len(panels),
              "panel_names": panels[:2], "card": card,
              "note": "sampling_s from the checkpoint's restore to the end: sampling, decode, "
                      "panels and PSNR/SSIM/FID with the seed-0 random Inception tower"})
        check(val_launches == {**{k: 0 for k in val_launches}, "fwd": want},
              f"reco validate launches {val_launches}, expected {want} forward")
        check({"metrics/psnr", "metrics/ssim"} <= set(scores) and all(
            np.isfinite(list(scores.values()))), f"predict_metrics.json {scores}")
        check(len(panels) == 16 and all(p.startswith("reconstruction_") for p in panels),
              f"side-by-side panels {panels}")
        torch.cuda.empty_cache()
        return {"fit": launches, "validate": val_launches, "stage3": phase_reco_448(card, seed)}
    finally:
        shutil.rmtree(RECO_DIR, ignore_errors=True)


def phase_reco_448(card: str, seed: int) -> dict:
    """One ``cli fit`` step of ReCo_large_stage3.yaml at its shipped batch
    (16 x 4 at 448 px), without the final checkpoint: its peak memory. The
    JAX ReCoModel has no remat option, so a step that does not fit in the
    card's memory is reported as out of memory (the result this phase
    measures), with the memory PyTorch held when it stopped."""
    import torch

    from deco_tpu_torch import cli
    from deco_tpu_torch.train import checkpoint

    kernels = _fit_kernels()
    write_image_folder(f"{RECO_DIR}/train_448", seed, per_class=8, sizes=((480, 512), (512, 480)))
    path = f"{RECO_DIR}/ReCo_large_stage3.yaml"
    config = _write_reco_config(path, RECO_448_CONFIG, f"{RECO_DIR}/train_448",
                                f"{RECO_DIR}/train_448", f"{RECO_DIR}/work_448")
    for f in kernels.values():
        f.launches = 0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        with Spy(checkpoint.CheckpointManager, "save", replace=lambda self, obj, step: None):
            state = cli.main(["fit", "-c", path, "--max_steps", "1"])
        torch.cuda.synchronize()
        result, error = "fits", None
        del state
    except torch.cuda.OutOfMemoryError as err:
        result, error = "out of memory", " ".join(str(err).split())[:300]
    row = {"phase": "reco_448_step", "config": RECO_448_CONFIG, "image_size": 448,
           "batch": config["data"]["train_batch_size"],
           "diffusion_batch_mul": config["model"]["diffusion_batch_mul"], "result": result,
           "error": error, "peak_mem_bytes": torch.cuda.max_memory_allocated(),
           "card_mem_bytes": torch.cuda.get_device_properties(0).total_memory,
           "seconds": time.perf_counter() - t0,
           "launches": {k: f.launches for k, f in kernels.items()}, "card": card}
    emit(row)
    torch.cuda.empty_cache()
    if result == "fits":
        per = {"fwd_lse": RECO_LAYERS, "bwd_dq": RECO_LAYERS, "bwd_dkv": RECO_LAYERS}
        check(row["launches"] == {**{k: 0 for k in row["launches"]}, **per},
              f"reco 448 launches {row['launches']}")
    return row


def _reco_timing_rows(timings: dict, keys: tuple) -> dict:
    """The kernels line's entries of one kernel at one family's shapes (the
    ReCo shapes, the VAE's at D = 32)."""
    return {name: {k: v for k, v in t.items() if k in keys + (
        "library_backend", "whole_backward_ms", "sdpa_backward_ms", "sdpa_backward_backend",
        "b_nq_nkv_h_d")}
        for name, t in timings.items()}


VAE_CONFIG = "configs/vae_training_stage2_224.yaml"
VAE_448_CONFIG = "configs/vae_training_stage2.yaml"
VAE_VAL_CONFIGS = {"224": "configs/vae_val_224px.yaml", "256": "configs/vae_val_256px.yaml"}
DCAE_EVAL_CONFIG = "configs_flow/dcae_decoder_eval.yaml"
VAE_DIR = "build/chip_smoke_vae"  # git-ignored; deleted at the end of the phase
# (B, Nq, Nkv, H, D): the DC-AE decoder's three attention stages (8^2,
# 16^2, 32^2 tokens at 224 px; 32, 32 and 16 heads of 32) at the fit batch
# 8; a 256 px validate batch of 32, padded to 280 px (10^2, 20^2, 40^2
# tokens: ragged); 448 px at its fit batch 16 (16^2, 32^2, 64^2)
VAE_SHAPES = {"fit224_64": (8, 64, 64, 32, 32), "fit224_256": (8, 256, 256, 32, 32),
              "fit224_1024": (8, 1024, 1024, 16, 32), "val256_100": (32, 100, 100, 32, 32),
              "val256_400": (32, 400, 400, 32, 32), "val256_1600": (32, 1600, 1600, 16, 32),
              "fit448_256": (16, 256, 256, 32, 32), "fit448_1024": (16, 1024, 1024, 32, 32),
              "fit448_4096": (16, 4096, 4096, 16, 32)}
# the plain versions' fp32 logits (and, in the backward, P, dP and dS) of a
# shape are held and timed on at most this many bytes of logits: the first
# rows of the batch (every (batch, head) is its own problem to the kernels)
VAE_PLAIN_LOGIT_BYTES = 4e9
VAE_FIT_STEPS = 3
# launches a fit step: the tower's 24 layers run forward with lse (the last
# six feed only the distillation's student features, which no loss reads
# while the run has no teacher, so they take no backward), the 18 up to the
# generation tap and the decoder's 9 attention blocks (3 stages x 3) run
# both backward kernels once: one backward a step (train/vae_gan_step.py)
VAE_TOWER_LAYERS, VAE_TAP, VAE_DECODER_ATTN = 24, 18, 9
# The VAE slice: VAEModel at full width with the tower cut to 4 layers (tap
# at 2) and the whole decoder (its 9 attention blocks at D = 32), batch 2 at
# 224 px, bf16 compute with fp32 parameters: the forward and the gradients
# of a reconstruction + student-feature loss, with the attention kernels
# against the plain attention on the card. The gates are 2x the CPU reading
# of bf16 against fp32 compute (--calibrate-vae-slice, VAE_SLICE_READINGS),
# set before the first card run: kernel vs plain changes only the
# attention's roundings, so it should read under bf16 vs fp32, and a zeroed
# attention reads 30-90x over each gate. The loss, which the attention
# hardly moves at random weights (the zeroed reading is the bf16 one), is
# held to 10x its bf16-vs-fp32 reading.
VAE_SLICE = dict(vit_num_layers=4, gen_select_layer=2)
VAE_SLICE_GATES = {"out_rel_l2": 0.031, "loss_rel": 1.1e-3, "grad_rel_l2": 0.016,
                   "attn_grad_rel_l2": 0.022, "tower_grad_rel_l2": 0.022}
VAE_SLICE_READINGS = {
    "bf16_vs_fp32": {"out_rel_l2": 0.0153, "loss_rel": 1.13e-4, "grad_rel_l2": 0.0080,
                     "attn_grad_rel_l2": 0.0109, "tower_grad_rel_l2": 0.0109},
    "zero_attention_vs_bf16": {"out_rel_l2": 0.978, "loss_rel": 1.26e-4, "grad_rel_l2": 0.723,
                               "attn_grad_rel_l2": 1.000, "tower_grad_rel_l2": 0.810}}


def _vae_slice_model(device: str, dtype: str = "bfloat16"):
    """VAE_CONFIG's model node cut to VAE_SLICE, every parameter drawn on the
    CPU from seed 0 with none zero: weights normal x 0.5 / sqrt(fan in),
    norm weights 1 + 0.1 normal (the decoder's attention outputs pass
    through such a norm), other vectors 0.1 normal."""
    import torch

    from deco_tpu_torch.config import registry

    node = registry.load_yaml(VAE_CONFIG)["model"]["vae_model"]
    model = registry.instantiate({**node, "init_args": {
        **node["init_args"], **VAE_SLICE, "dtype": dtype, "device": device,
        "load_pretrained_encoder": False}})
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for name, p in model.named_parameters():
            r = torch.randn(p.shape, generator=gen)
            if p.dim() >= 2:
                r = r * 0.5 / p[0].numel() ** 0.5
            elif name.endswith("weight") and "norm" in name:
                r = 1.0 + 0.1 * r
            else:
                r = 0.1 * r
            p.copy_(r)
    return model


def vae_slice_step(device: str, dtype: str = "bfloat16", attention: str = "kernel") -> dict:
    """The VAE slice's forward and gradients with fixed inputs and posterior
    noise: the reconstruction, the loss, all gradients and those of the
    decoder's attention blocks and of the tower, on the CPU in fp32.
    ``attention`` "plain" runs every attention through the plain version
    (autograd), "zero" gives zeros (the calibration's yardstick)."""
    import torch

    from deco_tpu_torch.models import layers
    from deco_tpu_torch.ops import flash_attention as fa

    model = _vae_slice_model(device, dtype)
    rng = np.random.default_rng(15)
    x = torch.from_numpy(rng.uniform(-1, 1, (2, 224, 224, 3)).astype(np.float32)).to(device)
    noise = torch.from_numpy(rng.standard_normal((2, 64, 32)).astype(np.float32)).to(device)
    kernel = layers.flash_attention
    if attention == "plain":
        layers.flash_attention = lambda q, k, v, scale=None, causal=False: (
            fa.flash_attention_plain(q, k, v, scale, causal=causal))
    elif attention == "zero":
        layers.flash_attention = lambda q, k, v, scale=None, causal=False: torch.zeros_like(q)
    try:
        recon, extra = model(x, noise=noise)
        loss = (((recon.float() - x) * 0.5) ** 2).mean() + 1e-3 * (
            extra["student_features"].float() ** 2).mean() + 1e-4 * extra["kl"]
        loss.backward()
    finally:
        layers.flash_attention = kernel

    def flat(named):
        return torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).float()
                          .reshape(-1).cpu() for _, p in named])

    named = list(model.named_parameters())
    return {"out": recon.detach().float().cpu(), "loss": float(loss.detach()),
            "grads": flat(named),
            "attn_grads": flat([(n, p) for n, p in named if ".attn." in n and "decoder" in n]),
            "tower_grads": flat([(n, p) for n, p in named if n.startswith("vision_model.")])}


def _vae_slice_rows(a: dict, b: dict) -> dict:
    return {"out_rel_l2": _rel_l2(a["out"], b["out"]),
            "loss_rel": abs(a["loss"] - b["loss"]) / abs(b["loss"]),
            "grad_rel_l2": _rel_l2(a["grads"], b["grads"]),
            "attn_grad_rel_l2": _rel_l2(a["attn_grads"], b["attn_grads"]),
            "tower_grad_rel_l2": _rel_l2(a["tower_grads"], b["tower_grads"])}


def calibrate_vae_slice() -> None:
    """On the CPU: the readings behind VAE_SLICE_GATES."""
    bf16 = vae_slice_step("cpu")
    print(json.dumps({"bf16_vs_fp32": _vae_slice_rows(bf16, vae_slice_step("cpu", "float32")),
                      "zero_attention_vs_bf16": _vae_slice_rows(
                          vae_slice_step("cpu", attention="zero"), bf16)}))


def phase_vae_kernels(card: str) -> dict:
    """The bf16 kernels at D = 32 (rows 1, 3, 5 and 6) at VAE_SHAPES against
    their plain versions (the forward bit-identical over two runs, the
    training kernels through ``hold_attention_training``), then timed beside
    the bound, the plain versions and the SDPA yardsticks; and each D = 32
    instantiation's registers, spills and resident CTAs."""
    import torch

    from deco_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(15)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")  # > the 50 MB L2
    errs = {"fwd": 0.0, "fwd_lse": 0.0, "bwd_dq": 0.0, "bwd_dkv": 0.0}
    timings: dict = {key: {} for key in errs}
    for name, shape in VAE_SHAPES.items():
        b, nq, nkv, h, d = shape
        hb = max(1, min(b, int(VAE_PLAIN_LOGIT_BYTES // (4 * h * nq * nkv))))
        q, k, v, do = attention_operands(gen, *shape)
        out, again = fa.flash_attention(q, k, v), fa.flash_attention(q, k, v)
        torch.cuda.synchronize()
        err = (out[:hb].float() - fa.flash_attention_plain(q[:hb], k[:hb], v[:hb]).float()
               ).abs().max().item()
        check(bool(torch.isfinite(out).all()) and err < ATTN_ATOL,
              f"vae attention {name} error {err} >= {ATTN_ATOL}")
        check(torch.equal(out, again), f"vae attention {name} differs between two runs")
        errs["fwd"] = max(errs["fwd"], err)
        timings["fwd"][name] = {
            "b_nq_nkv_h_d": list(shape), "max_abs_err": err, "held_b": hb,
            "ms": cuda_ms(lambda: fa.flash_attention(q, k, v), 30, flush),
            "plain_ms": cuda_ms(lambda: fa.flash_attention_plain(q[:hb], k[:hb], v[:hb]), 5,
                                flush), "plain_b": hb,
            **sdpa_forward_yardsticks(q, k, v, d ** -0.5, False, flush, 30),
            **_bound(card, 2 * (2 * q.numel() + k.numel() + v.numel()),
                     4 * b * h * nq * nkv * d)}
        emit({"phase": "vae_kernels", "timing": f"fwd_{name}", **timings["fwd"][name],
              "atol": ATTN_ATOL, "bit_identical": True, "l2": "flushed before each call",
              "card": card})
        row = hold_attention_training("vae_kernels", name, (hb, nq, nkv, h, d),
                                      [x[:hb] for x in (q, k, v, do)])
        for key, value in row["errs"].items():
            errs[key] = max(errs[key], value)
        for kernel, timing in _attention_timings(card, (q, k, v, do), flush, 20,
                                                 plain_b=hb).items():
            timings[kernel][name] = {"b_nq_nkv_h_d": list(shape), **timing}
            emit({"phase": "vae_kernels", "timing": f"{kernel}_{name}", **timings[kernel][name],
                  "l2": "flushed before each call", "card": card})
        del q, k, v, do, out, again
        torch.cuda.empty_cache()
    resources = {**fa.forward_kernel_info(32), **fa.backward_kernel_info(32)}
    emit({"phase": "vae_kernels", "d32_resources": resources, "card": card})
    for kind, info in resources.items():
        if kind != "flash_fwd_f32_kernel":
            check(info["local_bytes"] == 0, f"{kind}<32> uses local memory: {info}")
    return {"errs": errs, "timings": timings, "resources": resources}


def phase_vae_slice() -> dict:
    """The VAE slice on the card, kernels against the plain attention."""
    import torch

    from deco_tpu_torch.ops import flash_attention as fa

    kernels = (fa.flash_attention, fa.flash_attention_fwd_lse, fa.flash_attention_bwd_dq,
               fa.flash_attention_bwd_dkv)
    for f in kernels:
        f.launches = 0
    kernel = vae_slice_step("cuda")
    launches = [f.launches for f in kernels]
    torch.cuda.empty_cache()
    plain = vae_slice_step("cuda", attention="plain")
    plain_launches = [f.launches for f in kernels]
    torch.cuda.empty_cache()
    row = _vae_slice_rows(kernel, plain)
    # the slice's loss reads the student features: all 4 tower layers take a backward
    layers = backward = VAE_SLICE["vit_num_layers"] + VAE_DECODER_ATTN
    emit({"phase": "vae_slice_vs_plain", "config": VAE_CONFIG, "cut": VAE_SLICE, "batch": 2,
          "image_size": 224, **row, "gates": VAE_SLICE_GATES, "cpu_readings": VAE_SLICE_READINGS,
          "loss": kernel["loss"], "plain_loss": plain["loss"], "launches": launches,
          "params_with_grad": int(kernel["grads"].numel())})
    check(np.isfinite(kernel["loss"]) and bool(torch.isfinite(kernel["out"]).all()),
          "vae slice: not finite")
    check(launches == [0, layers, backward, backward],
          f"vae slice launches {launches}, expected [0, {layers}, {backward}, {backward}]")
    check(plain_launches == launches, "the plain VAE slice launched a kernel")
    for key, limit in VAE_SLICE_GATES.items():
        check(row[key] < limit, f"vae slice {key} {row[key]} >= {limit}")
    return row


def _write_vae_config(path: str, config_path: str, roots: dict, workroot: str,
                      **changes) -> dict:
    """``config_path`` as shipped but for its data nodes (``roots``: dataset
    key -> PNG folder, read by PixImageNet at the node's resolution: the
    card host's ``datasets`` would look for the hub dataset), its work
    directory and a log line every step; written to ``path``."""
    from deco_tpu_torch.config import _yaml, registry

    config = registry.load_yaml(config_path)
    for key, root in roots.items():
        node = config["data"][key]
        check(node["class_path"].endswith("PixHFDataset"), f"{config_path} {key} changed")
        config["data"][key] = {"class_path": "src.data.dataset.imagenet.PixImageNet",
                               "init_args": {"root": root,
                                             "resolution": node["init_args"]["resolution"]}}
    config["trainer"].update(default_root_dir=workroot, log_every_n_steps=1)
    for key, value in changes.items():
        registry.apply_overrides(config, {key: value})
    with open(path, "w") as f:
        f.write(_yaml.dump(config))
    return config


def phase_vae(card: str, seed: int) -> dict:
    """The VAE-GAN and the DC-AE eval through the CLI as users run them:
    ``cli fit`` on vae_training_stage2_224.yaml (3 steps, batch 8, one
    checkpoint), ``cli validate`` of vae_val_224px.yaml and vae_val_256px.yaml
    from it (one batch of 32 each), one more step with the discriminator
    started, one step of vae_training_stage2.yaml at 448 px (both without a
    checkpoint), and the DC-AE decoder eval (one batch of 32)."""
    import json
    import os
    import shutil

    import torch
    from torch.profiler import ProfilerActivity, profile

    from deco_tpu_torch import cli
    from deco_tpu_torch.train import checkpoint, vae_gan_step

    kernels = _fit_kernels()
    os.environ.setdefault("WANDB_MODE", "disabled")
    per_step = {"fwd_lse": VAE_TOWER_LAYERS + VAE_DECODER_ATTN,
                "bwd_dq": VAE_TAP + VAE_DECODER_ATTN, "bwd_dkv": VAE_TAP + VAE_DECODER_ATTN}

    def no_save(self, obj, step):  # in place of CheckpointManager.save
        return None

    try:
        images = write_image_folder(f"{VAE_DIR}/train", seed, per_class=16)
        evals = write_image_folder(f"{VAE_DIR}/eval", seed + 1, per_class=16)
        workroot = f"{VAE_DIR}/work"
        path = f"{VAE_DIR}/vae_training_stage2_224.yaml"
        config = _write_vae_config(path, VAE_CONFIG, {"train_dataset": f"{VAE_DIR}/train",
                                                      "eval_dataset": f"{VAE_DIR}/eval"},
                                   workroot)
        batch = config["data"]["train_batch_size"]
        for f in kernels.values():
            f.launches = 0
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with Spy(checkpoint.CheckpointManager, "save") as saves, \
                Spy(vae_gan_step, "make_vae_gan_step") as makes, \
                profile(activities=[ProfilerActivity.CUDA]) as prof:
            state = cli.main(["fit", "-c", path, "--max_steps", str(VAE_FIT_STEPS)])
        fit_s = time.perf_counter() - t0
        launches = {k: f.launches for k, f in kernels.items()}
        peak = torch.cuda.max_memory_allocated()
        workdir = f"{workroot}/{config['tags']['exp']}"
        records, ends, step_s = _fit_records(workdir)
        busy_ms = _kernel_busy_ms(prof)
        ckpt_path = f"{workdir}/checkpoints/{VAE_FIT_STEPS}.pt"
        vae = state.vae
        fit = {"phase": "vae_fit", "config": VAE_CONFIG, "images": images, "batch": batch,
               "steps": VAE_FIT_STEPS, "metrics": records, "step_s": step_s,
               "s_per_step": float(np.median(step_s[1:])), "images_per_s":
                   batch / float(np.median(step_s[1:])),
               "device_kernel_ms": busy_ms, "kernel_ms_by_kind": _kernel_ms_by_kind(prof),
               "idle_share": 1 - busy_ms / 1e3 / ends[-1], "peak_mem_bytes": peak,
               "fit_call_s": fit_s, "launches": launches,
               "launches_per_step": {k: v / VAE_FIT_STEPS for k, v in launches.items()},
               "checkpoint_bytes": os.path.getsize(ckpt_path),
               "checkpoint_save_s": [c["seconds"] for c in saves.calls],
               "params": sum(p.numel() for p in vae.parameters()),
               "disc_params": sum(p.numel() for p in state.disc.parameters()), "card": card,
               "note": "timed under torch.profiler (CUDA activity); step_s from metrics.jsonl"}
        emit(fit)
        check(type(vae).__name__ == "VAEModel" and vae.stochastic
              and len(vae.vision_model.encoder.layers) == VAE_TOWER_LAYERS
              and vae.dtype == torch.bfloat16, "the fit did not build the shipped VAEModel")
        check(len(records) == VAE_FIT_STEPS and all(
            np.isfinite(r[k]) for r in records for k in ("total_loss", "gen_grad_norm",
                                                          "discriminator_loss")),
              f"vae fit metrics {records}")
        expected = {k: 0 for k in launches}
        expected.update({k: n * VAE_FIT_STEPS for k, n in per_step.items()})
        check(launches == expected, f"vae fit launches {launches}, expected {expected}")
        check(len(saves.calls) == 1, f"{len(saves.calls)} checkpoint saves, expected the final one")
        emit({"phase": "vae_step_breakdown", **_vae_step_breakdown(makes.calls[0]["out"], state,
                                                                     batch), "card": card})
        del state, vae
        torch.cuda.empty_cache()

        validate = {}
        for res, val_config in VAE_VAL_CONFIGS.items():
            vpath = f"{VAE_DIR}/{os.path.basename(val_config)}"
            vconfig = _write_vae_config(vpath, val_config, {"eval_dataset": f"{VAE_DIR}/eval"},
                                        workroot)
            for f in kernels.values():
                f.launches = 0
            t0 = time.perf_counter()
            scores = cli.main(["validate", "-c", vpath, f"--ckpt_path={workdir}/checkpoints",
                               "--max_batches", "1"])
            torch.cuda.synchronize()
            vdir = f"{workroot}/{vconfig['tags']['exp']}"
            val_launches = {k: f.launches for k, f in kernels.items()}
            panels = sorted(os.listdir(f"{vdir}/images"))
            validate[res] = {"launches": val_launches, "scores": scores}
            emit({"phase": f"vae_validate_{res}", "config": val_config,
                  "batch": vconfig["data"]["pred_batch_size"], "eval_images": evals,
                  "seconds": time.perf_counter() - t0, "launches": val_launches,
                  "scores": scores, "panels": len(panels), "card": card,
                  "note": "one batch; FID with the seed-0 random Inception tower"})
            check({"metrics/psnr", "metrics/ssim", "metrics/fid"} <= set(scores) and all(
                np.isfinite(list(scores.values()))), f"validate {res} scores {scores}")
            want = {**{k: 0 for k in val_launches}, "fwd": VAE_TOWER_LAYERS + VAE_DECODER_ATTN}
            check(val_launches == want, f"validate {res} launches {val_launches}, want {want}")
            check(json.load(open(f"{vdir}/validate_metrics.json")) == scores,
                  "validate_metrics.json")
            torch.cuda.empty_cache()
        shutil.rmtree(f"{workdir}/checkpoints")  # the phase keeps one checkpoint at a time

        # one more step with the discriminator started (its GAN term and the
        # adaptive weight carry gradient), without a checkpoint
        spath = f"{VAE_DIR}/vae_disc_start.yaml"
        sconfig = _write_vae_config(
            spath, VAE_CONFIG, {"train_dataset": f"{VAE_DIR}/train"}, f"{VAE_DIR}/work_disc",
            **{"model.loss_module.init_args.discriminator_start": 0})
        for f in kernels.values():
            f.launches = 0
        with Spy(checkpoint.CheckpointManager, "save", replace=no_save):
            state = cli.main(["fit", "-c", spath, "--max_steps", "1"])
        torch.cuda.synchronize()
        (rec,), _, (disc_step_s,) = _fit_records(f"{VAE_DIR}/work_disc/{sconfig['tags']['exp']}")
        disc_launches = {k: f.launches for k, f in kernels.items()}
        emit({"phase": "vae_disc_start_step", "config": VAE_CONFIG,
              "override": "model.loss_module.init_args.discriminator_start=0", "metrics": rec,
              "step_s": disc_step_s, "launches": disc_launches, "card": card})
        check(rec["d_weight"] > 0 and np.isfinite(rec["gan_loss"]) and
              np.isfinite(rec["total_loss"]) and rec["discriminator_loss"] > 0,
              f"the started discriminator's step {rec}")
        check(disc_launches == {**{k: 0 for k in disc_launches}, **per_step},
              f"disc-start step launches {disc_launches}")
        del state
        torch.cuda.empty_cache()
        stage2 = phase_vae_448(card, seed, per_step, no_save)
        dcae = phase_dcae_eval(card)
        return {"fit": launches, "validate": {r: v["launches"] for r, v in validate.items()},
                "disc_start": disc_launches, "448": stage2, "dcae_eval": dcae,
                "per_step": per_step}
    finally:
        shutil.rmtree(VAE_DIR, ignore_errors=True)


def _vae_step_breakdown(step_fn, state, batch: int) -> dict:
    """The fit's own step function on the fit's state, steady: the wall
    time of a step ended by a synchronize (median of 3 after one more
    warm-up), then one more step's device time by kind of kernel
    (:func:`profile_breakdown`); synthetic images of the fit's shape."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(7)
    x = torch.rand(batch, 224, 224, 3, generator=gen, device="cuda") * 2 - 1

    def one():
        step_fn(state, x, generator=gen)
        torch.cuda.synchronize()

    walls = []
    for _ in range(4):
        t0 = time.perf_counter()
        one()
        walls.append(time.perf_counter() - t0)
    return {"step_wall_s": walls, **profile_breakdown(one, float(np.median(walls[1:])) * 1e3)}


def phase_vae_448(card: str, seed: int, per_step: dict, no_save) -> dict:
    """One ``cli fit`` step of vae_training_stage2.yaml at its shipped batch
    (16 at 448 px) without a checkpoint: its peak memory, or "out of memory"
    with what PyTorch held when it stopped (no remat option in the JAX model)."""
    import torch

    from deco_tpu_torch import cli
    from deco_tpu_torch.train import checkpoint

    kernels = _fit_kernels()
    write_image_folder(f"{VAE_DIR}/train_448", seed, per_class=8, sizes=((480, 512), (512, 480)))
    path = f"{VAE_DIR}/vae_training_stage2.yaml"
    config = _write_vae_config(path, VAE_448_CONFIG, {"train_dataset": f"{VAE_DIR}/train_448"},
                               f"{VAE_DIR}/work_448")
    for f in kernels.values():
        f.launches = 0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        with Spy(checkpoint.CheckpointManager, "save", replace=no_save):
            state = cli.main(["fit", "-c", path, "--max_steps", "1"])
        torch.cuda.synchronize()
        result, error = "fits", None
        del state
    except torch.cuda.OutOfMemoryError as err:
        result, error = "out of memory", " ".join(str(err).split())[:300]
    row = {"phase": "vae_448_step", "config": VAE_448_CONFIG, "image_size": 448,
           "batch": config["data"]["train_batch_size"], "result": result, "error": error,
           "peak_mem_bytes": torch.cuda.max_memory_allocated(),
           "card_mem_bytes": torch.cuda.get_device_properties(0).total_memory,
           "seconds": time.perf_counter() - t0,
           "launches": {k: f.launches for k, f in kernels.items()}, "card": card}
    emit(row)
    torch.cuda.empty_cache()
    if result == "fits":
        check(row["launches"] == {**{k: 0 for k in row["launches"]}, **per_step},
              f"vae 448 launches {row['launches']}")
    return row


def phase_dcae_eval(card: str) -> dict:
    """``cli validate -c configs_flow/dcae_decoder_eval.yaml`` for one batch of
    32 from a PNG folder (the config's root is the hub dataset's path): the
    random InternViT-300M encoder and DC-AE eval decoder, finite PSNR and
    SSIM, 24 + 9 forward launches."""
    import os

    import torch

    from deco_tpu_torch import cli
    from deco_tpu_torch.config import _yaml, registry

    kernels = _fit_kernels()
    write_image_folder(f"{VAE_DIR}/dcae_eval", 3, per_class=16)
    path = f"{VAE_DIR}/dcae_decoder_eval.yaml"
    config = registry.load_yaml(DCAE_EVAL_CONFIG)
    config["data"]["eval_dataset"]["init_args"]["root"] = os.path.abspath(f"{VAE_DIR}/dcae_eval")
    with open(path, "w") as f:
        f.write(_yaml.dump(config))
    for f in kernels.values():
        f.launches = 0
    t0 = time.perf_counter()
    result = cli.main(["validate", "-c", path, "--max_batches", "1"])
    torch.cuda.synchronize()
    launches = {k: f.launches for k, f in kernels.items()}
    emit({"phase": "dcae_eval", "config": DCAE_EVAL_CONFIG, "result": result,
          "batch": config["data"]["pred_batch_size"], "seconds": time.perf_counter() - t0,
          "launches": launches, "card": card})
    check(result["num_batches"] == 1 and np.isfinite(result["psnr"])
          and np.isfinite(result["ssim"]), f"dcae eval {result}")
    want = {**{k: 0 for k in launches}, "fwd": VAE_TOWER_LAYERS + VAE_DECODER_ATTN}
    check(launches == want, f"dcae eval launches {launches}, want {want}")
    torch.cuda.empty_cache()
    return launches


UNIFLOW_CONFIG = "configs_flow/uniflow_internvit_2b_base.yaml"
UNIFLOW_448_CONFIG = "configs_flow/uniflow_internvit_2b_blip3o_stage2.yaml"
UNIFLOW_SEM_CONFIG = "configs_flow/uniflow_internvit_2b_blip3o_sem.yaml"
UNIFLOW_DIR = "build/chip_smoke_uniflow"  # git-ignored; deleted at the end of the phase
# (B, Nq, Nkv, H, D): the causal semantic trunk (32 heads of 64) at the fit
# batch 16 at 448 px (16^2 latent tokens) and 224 px (8^2), 896 px at batch
# 2 (32^2), and a ragged 10^2 (the 280 px canvas of a 256 px validate)
UNIFLOW_CAUSAL_SHAPES = {"n256": (16, 256, 256, 32, 64), "n64": (16, 64, 64, 32, 64),
                         "n1024": (2, 1024, 1024, 32, 64), "ragged100": (16, 100, 100, 32, 64)}
UNIFLOW_FIT_STEPS = 3
# launches a step: the InternViT's 24 layers, the shallow ViT's 4 and the
# pixel trunk's 6 blocks non-causal, the semantic trunk's 6 causal; every
# one takes both backward kernels (the frozen towers' gradients are taken
# for the clip's norm, as in JAX)
UNIFLOW_TOWER, UNIFLOW_SHALLOW, UNIFLOW_TRUNK = 24, 4, 6
# The UniFlow slice: the full widths with the InternViT cut to 2 layers, the
# shallow ViT to 1 and each trunk to 1 block, batch 2 at 224 px, bf16
# compute with fp32 parameters, the same weights, images and draws on the
# card (the kernels) and on the CPU (the plain versions). The gates are 2x
# the CPU reading of bf16 against fp32 compute (--calibrate-uniflow-slice,
# UNIFLOW_SLICE_READINGS), set before the first card run: card against CPU
# changes only roundings, so it should read under bf16 vs fp32, while a
# zeroed attention reads 4-100x over each gradient gate. The loss terms,
# which the attention hardly moves at random weights (the zeroed reading is
# under the bf16 one), are held to 10x their bf16-vs-fp32 readings.
UNIFLOW_SLICE = dict(num_hidden_layers=2, global_blocks_depth=1)
UNIFLOW_SLICE_SHALLOW = 1
UNIFLOW_SLICE_GATES = {"distill_loss_rel": 5e-3, "sem_mse_loss_rel": 4e-4,
                       "flow_loss_rel": 5e-4, "loss_rel": 4e-4, "grads_rel_l2": 0.0144,
                       "causal_trunk_grads_rel_l2": 0.0195, "pixel_trunk_grads_rel_l2": 0.0168,
                       "tower_grads_rel_l2": 0.0158, "shallow_grads_rel_l2": 0.0292}
UNIFLOW_SLICE_READINGS = {
    "bf16_vs_fp32": {"distill_loss_rel": 4.98e-4, "sem_mse_loss_rel": 3.85e-5,
                     "flow_loss_rel": 5.02e-5, "loss_rel": 4.11e-5, "grads_rel_l2": 0.0072,
                     "causal_trunk_grads_rel_l2": 0.0098, "pixel_trunk_grads_rel_l2": 0.0084,
                     "tower_grads_rel_l2": 0.0079, "shallow_grads_rel_l2": 0.0146},
    "zero_attention_vs_bf16": {"distill_loss_rel": 5.4e-6, "sem_mse_loss_rel": 1.37e-5,
                               "flow_loss_rel": 7.0e-6, "loss_rel": 1.08e-5,
                               "grads_rel_l2": 0.0569, "causal_trunk_grads_rel_l2": 0.988,
                               "pixel_trunk_grads_rel_l2": 0.966, "tower_grads_rel_l2": 0.321,
                               "shallow_grads_rel_l2": 0.787}}


def _uniflow_slice_model(device: str, dtype: str = "bfloat16"):
    """The slice's UniFlowVision, every parameter drawn from seed 0 (normal
    x 0.5 / sqrt(fan in), norm scales 1 + 0.1 normal; no parameter zero, so
    the zero-initialised modulations and heads carry gradient)."""
    import dataclasses

    import torch

    from deco_tpu_torch.models.uniflow.model import UniFlowConfig, UniFlowVision

    cfg = dataclasses.replace(UniFlowConfig.from_pretrained(), **UNIFLOW_SLICE)
    model = UniFlowVision(cfg, dtype=getattr(torch, dtype), device="cpu")
    model.shallow_encoder.layers = model.shallow_encoder.layers[:UNIFLOW_SLICE_SHALLOW]
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for name, p in model.named_parameters():
            r = torch.randn(p.shape, generator=gen)
            if name.endswith(("norm1.weight", "norm2.weight", "norm.weight", "in_ln.weight",
                              "mlp1.0.weight")) or name.endswith(("q_norm.weight",
                                                                  "k_norm.weight")):
                p.copy_(1.0 + 0.1 * r)
            else:
                p.copy_(r * 0.5 / (p[0].numel() if p.dim() > 1 else p.numel()) ** 0.5)
    return model.to(device)


def uniflow_slice_step(device: str, dtype: str = "bfloat16", attention: str = "kernel") -> dict:
    """One ``forward_loss`` and its gradients of the slice model at batch 2
    (224 px) with fixed images and draws: the five loss terms and the
    gradients by group, on the CPU in fp32. ``attention`` "zero" gives zeros
    for every attention (the calibration's yardstick)."""
    import torch

    from deco_tpu_torch.models import layers

    model = _uniflow_slice_model(device, dtype)
    rng = np.random.default_rng(16)
    x = torch.from_numpy(rng.uniform(-1, 1, (2, 224, 224, 3)).astype(np.float32)).to(device)

    def draws(n, c):
        return {"t_normal": rng.standard_normal((2, n)).astype(np.float32),
                "t_mix": rng.uniform(0, 1, (2, n)).astype(np.float32),
                "t_uniform": rng.uniform(0, 1, (2, n)).astype(np.float32),
                "x0": rng.standard_normal((2, n, c)).astype(np.float32)}

    d = {"sem": draws(64, 4096), "pix": draws(256, 588)}
    kernel = layers.flash_attention
    if attention == "zero":
        layers.flash_attention = lambda q, k, v, scale=None, causal=False: torch.zeros_like(q)
    try:
        losses = model.forward_loss(x, draws=d)
        losses["loss"].backward()
    finally:
        layers.flash_attention = kernel

    def flat(prefix=""):  # a parameter the loss does not read (the mask tokens): zeros
        return torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).float()
                          .reshape(-1).cpu() for n, p in model.named_parameters()
                          if n.startswith(prefix)])

    return {"losses": {k: float(v.detach()) for k, v in losses.items()},
            "grads": flat(), "causal_trunk_grads": flat("sem_global_blocks."),
            "pixel_trunk_grads": flat("global_blocks."), "tower_grads": flat("encoder."),
            "shallow_grads": flat("shallow_encoder.")}


def _uniflow_slice_rows(a: dict, b: dict) -> dict:
    """Each reading of ``a`` against ``b``: the relative difference of each
    loss term, relative L2 of the gradients, all and by group."""
    row = {f"{k}_rel": abs(a["losses"][k] - v) / abs(v) for k, v in b["losses"].items()
           if k != "lpips_loss" and v}
    row.update({f"{k}_rel_l2": _rel_l2(a[k], b[k]) for k in (
        "grads", "causal_trunk_grads", "pixel_trunk_grads", "tower_grads", "shallow_grads")})
    return row


def calibrate_uniflow_slice() -> None:
    """On the CPU: the readings between which UNIFLOW_SLICE_GATES sit."""
    bf16 = uniflow_slice_step("cpu")
    print(json.dumps({"bf16_vs_fp32": _uniflow_slice_rows(bf16, uniflow_slice_step(
        "cpu", "float32")), "zero_attention_vs_bf16": _uniflow_slice_rows(
        uniflow_slice_step("cpu", attention="zero"), bf16)}))


def _causal_kernels():
    from deco_tpu_torch.ops import flash_attention as fa

    return {"fwd": fa.flash_attention, "fwd_lse": fa.flash_attention_fwd_lse,
            "bwd_dq": fa.flash_attention_bwd_dq, "bwd_dkv": fa.flash_attention_bwd_dkv}


def _reset_launches() -> None:
    for f in {**_fit_kernels(), **_causal_kernels()}.values():
        f.launches = 0
    for f in _causal_kernels().values():
        f.causal_launches = 0


def _uniflow_launches() -> dict:
    """The launches since :func:`_reset_launches`: each kernel's, and each
    causal instantiation's under ``<name>_causal``."""
    out = {k: f.launches for k, f in _fit_kernels().items()}
    out.update({f"{k}_causal": f.causal_launches for k, f in _causal_kernels().items()})
    return out


def phase_uniflow_kernels(card: str) -> dict:
    """The four causal instantiations at UNIFLOW_CAUSAL_SHAPES against their
    masked plain versions (the forward bit-identical over two runs, the
    training kernels through ``hold_attention_training``), timed beside the
    bound (half the non-causal operations, or the bytes), the plain versions
    and SDPA's ``is_causal`` as a yardstick; and each one's registers,
    spills, shared memory and resident CTAs."""
    import torch

    from deco_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(16)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")  # > the 50 MB L2
    errs = {"fwd": 0.0, "fwd_lse": 0.0, "bwd_dq": 0.0, "bwd_dkv": 0.0}
    scaled = {"fwd": 0.0, "fwd_lse": 0.0}  # the gated errors, in units of max(1, |plain|)
    timings: dict = {key: {} for key in errs}
    for name, shape in UNIFLOW_CAUSAL_SHAPES.items():
        b, nq, nkv, h, d = shape
        q, k, v, do = attention_operands(gen, *shape)
        out = fa.flash_attention(q, k, v, causal=True)
        again = fa.flash_attention(q, k, v, causal=True)
        torch.cuda.synchronize()
        ref = fa.flash_attention_plain(q, k, v, causal=True)
        err, abs_err = _attn_err(out, ref, causal=True), _attn_err(out, ref)
        check(bool(torch.isfinite(out).all()) and err < ATTN_ATOL,
              f"causal attention {name} error {err} >= {ATTN_ATOL} x max(1, |plain|)")
        check(torch.equal(out, again), f"causal attention {name} differs between two runs")
        errs["fwd"], scaled["fwd"] = max(errs["fwd"], abs_err), max(scaled["fwd"], err)
        timings["fwd"][name] = {
            "b_nq_nkv_h_d": list(shape), "max_abs_err": abs_err, "max_err_scaled": err,
            "ms": cuda_ms(lambda: fa.flash_attention(q, k, v, causal=True), 30, flush),
            "plain_ms": cuda_ms(lambda: fa.flash_attention_plain(q, k, v, causal=True), 5,
                                flush),
            **sdpa_forward_yardsticks(q, k, v, d ** -0.5, False, flush, 30, causal=True),
            **_bound(card, 2 * (2 * q.numel() + k.numel() + v.numel()),
                     4 * b * h * nq * nkv * d / 2)}
        emit({"phase": "uniflow_kernels", "timing": f"fwd_causal_{name}",
              **timings["fwd"][name], "atol": ATTN_ATOL, "atol_unit": "max(1, |plain|)",
              "bit_identical": True,
              "l2": "flushed before each call", "card": card})
        row = hold_attention_training("uniflow_kernels", name, shape, (q, k, v, do), causal=True)
        for key, value in row["errs"].items():
            errs[key] = max(errs[key], value)
        scaled["fwd_lse"] = max(scaled["fwd_lse"], row["o_max_err"])
        for kernel, timing in _attention_timings(card, (q, k, v, do), flush, 20,
                                                 causal=True).items():
            timings[kernel][name] = {"b_nq_nkv_h_d": list(shape), **timing}
            emit({"phase": "uniflow_kernels", "timing": f"{kernel}_causal_{name}",
                  **timings[kernel][name], "l2": "flushed before each call", "card": card})
        del q, k, v, do, out, again, ref
        torch.cuda.empty_cache()
    resources = {k: v for k, v in {**fa.forward_kernel_info(64),
                                   **fa.backward_kernel_info(64)}.items() if "causal" in k}
    emit({"phase": "uniflow_kernels", "causal_resources": resources, "card": card})
    check(len(resources) == 4, f"causal instantiations {sorted(resources)}")
    for kind, info in resources.items():
        check(info["local_bytes"] == 0, f"{kind}<64> uses local memory: {info}")
    return {"errs": errs, "scaled": scaled, "timings": timings, "resources": resources}


def phase_uniflow_slice() -> dict:
    """The UniFlow slice, the card's kernels against the CPU's plain versions."""
    import torch

    _reset_launches()
    card = uniflow_slice_step("cuda")
    launches = _uniflow_launches()
    torch.cuda.empty_cache()
    cpu = uniflow_slice_step("cpu")
    row = _uniflow_slice_rows(card, cpu)
    layers = UNIFLOW_SLICE["num_hidden_layers"] + UNIFLOW_SLICE_SHALLOW + UNIFLOW_SLICE[
        "global_blocks_depth"]
    causal = UNIFLOW_SLICE["global_blocks_depth"]
    emit({"phase": "uniflow_slice_vs_plain", "config": "the vendored config.json",
          "cut": {**UNIFLOW_SLICE, "shallow_layers": UNIFLOW_SLICE_SHALLOW}, "batch": 2,
          "image_size": 224, **row, "gates": UNIFLOW_SLICE_GATES,
          "cpu_readings": UNIFLOW_SLICE_READINGS, "losses": card["losses"],
          "cpu_losses": cpu["losses"], "launches": launches,
          "params_with_grad": int(card["grads"].numel())})
    check(all(np.isfinite(list(card["losses"].values()))), f"uniflow slice {card['losses']}")
    want = {**{k: 0 for k in launches}, "fwd_lse": layers, "bwd_dq": layers, "bwd_dkv": layers,
            "fwd_lse_causal": causal, "bwd_dq_causal": causal, "bwd_dkv_causal": causal}
    check(launches == want, f"uniflow slice launches {launches}, expected {want}")
    for key, limit in UNIFLOW_SLICE_GATES.items():
        check(row[key] < limit, f"uniflow slice {key} {row[key]} >= {limit}")
    return row


def _write_uniflow_config(path: str, config_path: str, workroot: str, train=None,
                          eval_root=None) -> dict:
    """``config_path`` as shipped but for its data nodes (``train``: a PNG
    folder read by PixImageNet, or for a PixWebDataset node a tar shard in
    place of its ``data_files``; ``eval_root`` a PNG folder; each at the
    node's resolution: the card host's ``datasets`` would look for the hub
    dataset), its work directory and a log line every step."""
    from deco_tpu_torch.config import _yaml, registry

    config = registry.load_yaml(config_path)
    node = config["data"]["train_dataset"]
    if node["class_path"].endswith("PixWebDataset"):
        node["init_args"]["data_files"] = train
    else:
        check(node["class_path"].endswith("PixHFDataset"), f"{config_path} train node changed")
        config["data"]["train_dataset"] = {
            "class_path": "src.data.dataset.imagenet.PixImageNet",
            "init_args": {"root": train, "resolution": node["init_args"]["resolution"]}}
    if eval_root is not None:
        enode = config["data"]["eval_dataset"]
        check(enode["class_path"].endswith("PixHFDataset"), f"{config_path} eval node changed")
        config["data"]["eval_dataset"] = {
            "class_path": "src.data.dataset.imagenet.PixImageNet",
            "init_args": {"root": eval_root, "resolution": enode["init_args"]["resolution"]}}
    config["trainer"].update(default_root_dir=workroot, log_every_n_steps=1)
    with open(path, "w") as f:
        f.write(_yaml.dump(config))
    return config


class _MemoryCheckpoints:
    """``CheckpointManager.save`` and ``load`` in host memory: the payload
    goes through ``torch.save`` into a buffer (its bytes and seconds are the
    checkpoint's) and comes back through ``torch.load``, without a disk write."""

    def __init__(self):
        self.files: dict = {}
        self.saves: list = []

    def save(self, manager, obj, step):
        import io

        import torch

        t0 = time.perf_counter()
        buf = io.BytesIO()
        torch.save(obj, buf)
        self.files[(manager.directory, int(step))] = buf
        self.saves.append({"bytes": buf.getbuffer().nbytes, "seconds": time.perf_counter() - t0})
        return f"memory:{manager.directory}/{step}.pt"

    def latest_step(self, manager):
        steps = [s for d, s in self.files if d == manager.directory]
        return max(steps) if steps else None

    def load(self, manager, step=None):
        import torch

        step = self.latest_step(manager) if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {manager.directory}")
        buf = self.files[(manager.directory, int(step))]
        buf.seek(0)
        return torch.load(buf, weights_only=True)


def _uniflow_step_breakdown(exp, state, batch: int) -> dict:
    """The fit's own step (``UniFlowExperiment.train_step``) on the fit's
    state, steady: the wall time of a step ended by a synchronize (median of
    3 after one more warm-up), then one more step's device time by kind of
    kernel (:func:`profile_breakdown`); synthetic images of the fit's shape."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(7)
    x = torch.rand(batch, 224, 224, 3, generator=gen, device="cuda") * 2 - 1

    def one():
        exp.train_step(state, x, generator=gen)
        torch.cuda.synchronize()

    walls = []
    for _ in range(4):
        t0 = time.perf_counter()
        one()
        walls.append(time.perf_counter() - t0)
    return {"step_wall_s": walls, **profile_breakdown(one, float(np.median(walls[1:])) * 1e3)}


def _uniflow_one_step(path: str, card: str) -> dict:
    """``cli fit`` of one step of ``path`` without a checkpoint: its peak
    memory, s/step and launches, or "out of memory" with what PyTorch held."""
    import torch

    from deco_tpu_torch import cli
    from deco_tpu_torch.train import checkpoint

    _reset_launches()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        with Spy(checkpoint.CheckpointManager, "save", replace=lambda self, obj, step: None):
            state = cli.main(["fit", "-c", path, "--max_steps", "1"])
        torch.cuda.synchronize()
        result, error = "fits", None
        del state
    except torch.cuda.OutOfMemoryError as err:
        result, error = "out of memory", " ".join(str(err).split())[:300]
    row = {"result": result, "error": error, "seconds": time.perf_counter() - t0,
           "peak_mem_bytes": torch.cuda.max_memory_allocated(),
           "card_mem_bytes": torch.cuda.get_device_properties(0).total_memory,
           "launches": _uniflow_launches(), "card": card}
    torch.cuda.empty_cache()
    return row


def phase_uniflow(card: str, seed: int) -> dict:
    """UniFlow through the CLI as users run it. ``uniflow_fit``: ``cli fit``
    on uniflow_internvit_2b_base.yaml as shipped (the full 1.09B model,
    batch 16 at 224 px, the vision towers frozen, its WandbLogger node kept)
    but for its data nodes (PixImageNet over seeded PNG folders), the work
    directory and 3 steps. Its checkpoint (~10 GB: parameters and the
    trainable ones' AdamW moments) is serialized into host memory, not
    written: phases 9-15 write ~45 GB of the call's 45 GiB of disk writes,
    and no depth cut at full width brings the checkpoint under the ~3 GB
    left while keeping the exact launches a step (34 + 6 causal), so the
    model keeps its full depth. ``uniflow_validate``: ``cli validate`` from
    that checkpoint, one batch of 32 at 256 px (padded to 280): 34 forward
    launches, no causal one, a (32, 256, 256, 3) reconstruction, PSNR, SSIM
    and FID. ``uniflow_semantic``: the validated model's semantic
    reconstruction of a batch (28 + 6 causal forward launches).
    ``uniflow_448``: one step of uniflow_internvit_2b_blip3o_stage2.yaml
    (EMA, frozen encoder) at its shipped batch 16 at 448 px from its
    PixWebDataset node (random crop and flip) over a seeded PNG tar shard,
    without a checkpoint: peak memory (or "out of memory") and s/step.
    ``uniflow_sem``: one step of uniflow_internvit_2b_blip3o_sem.yaml, the
    pixel branch off (28 + 6 causal launches), without a checkpoint."""
    import importlib.util
    import json
    import os
    import shutil

    import torch
    from torch.profiler import ProfilerActivity, profile

    from deco_tpu_torch import cli
    from deco_tpu_torch.train import checkpoint, workloads
    from deco_tpu_torch.utils.flops import card_peaks, uniflow_flops

    os.environ.setdefault("WANDB_MODE", "disabled")
    has_wandb = importlib.util.find_spec("wandb") is not None
    memory = _MemoryCheckpoints()
    layers = UNIFLOW_TOWER + UNIFLOW_SHALLOW + UNIFLOW_TRUNK
    per_step = {"fwd_lse": layers, "bwd_dq": layers, "bwd_dkv": layers,
                "fwd_lse_causal": UNIFLOW_TRUNK, "bwd_dq_causal": UNIFLOW_TRUNK,
                "bwd_dkv_causal": UNIFLOW_TRUNK}
    try:
        images = write_image_folder(f"{UNIFLOW_DIR}/train", seed, per_class=16)
        evals = write_image_folder(f"{UNIFLOW_DIR}/eval", seed + 1, per_class=16)
        workroot = f"{UNIFLOW_DIR}/work"
        path = f"{UNIFLOW_DIR}/uniflow_internvit_2b_base.yaml"
        config = _write_uniflow_config(path, UNIFLOW_CONFIG, workroot, f"{UNIFLOW_DIR}/train",
                                       f"{UNIFLOW_DIR}/eval")
        batch = config["data"]["train_batch_size"]
        _reset_launches()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with Spy(checkpoint.CheckpointManager, "save", replace=memory.save), \
                Spy(workloads.UniFlowRun, "fit") as fits, \
                profile(activities=[ProfilerActivity.CUDA]) as prof:
            state = cli.main(["fit", "-c", path, "--max_steps", str(UNIFLOW_FIT_STEPS)])
        fit_s = time.perf_counter() - t0
        launches = _uniflow_launches()
        peak = torch.cuda.max_memory_allocated()
        workdir = f"{workroot}/{config['tags']['exp']}"
        records, ends, step_s = _fit_records(workdir)
        s_per_step = float(np.median(step_s[1:]))
        busy_ms = _kernel_busy_ms(prof)
        flops = 3 * uniflow_flops() * batch
        terms = ("distill_loss", "vit_distill_loss", "sem_mse_loss", "flow_loss", "lpips_loss")
        fit = {"phase": "uniflow_fit", "config": UNIFLOW_CONFIG, "images": images,
               "batch": batch, "image_size": 224, "steps": UNIFLOW_FIT_STEPS,
               "wandb": "importable (WANDB_MODE=disabled)" if has_wandb else "absent: JSONL only",
               "losses": {k: [r[k] for r in records] for k in terms + ("loss", "grad_norm")},
               "step_s": step_s, "s_per_step": s_per_step, "images_per_s": batch / s_per_step,
               "mfu": flops / s_per_step / card_peaks(card)[0], "flops_per_step": flops,
               "device_kernel_ms": busy_ms, "kernel_ms_by_kind": _kernel_ms_by_kind(prof),
               "idle_share": 1 - busy_ms / 1e3 / ends[-1], "peak_mem_bytes": peak,
               "fit_call_s": fit_s, "launches": launches,
               "launches_per_step": {k: v / UNIFLOW_FIT_STEPS for k, v in launches.items()},
               "checkpoint_bytes": [s["bytes"] for s in memory.saves],
               "checkpoint_save_s": [s["seconds"] for s in memory.saves],
               "checkpoint_note": "torch.save into host memory (no disk write: the call's "
                                  "45 GiB write budget)",
               "params": sum(p.numel() for p in state.model.parameters()),
               "trainable_params": sum(p.numel() for g in state.optimizer.param_groups
                                       for p in g["params"]), "card": card,
               "note": "timed under torch.profiler (CUDA activity); step_s from metrics.jsonl"}
        emit(fit)
        model = state.model
        check(type(model).__name__ == "UniFlowVision" and len(model.encoder.layers) == UNIFLOW_TOWER
              and len(model.sem_global_blocks) == UNIFLOW_TRUNK and model.dtype == torch.bfloat16
              and all(b.is_causal for b in model.sem_global_blocks),
              "the fit did not build the shipped UniFlowVision")
        check(len(records) == UNIFLOW_FIT_STEPS and all(
            np.isfinite(r[k]) for r in records for k in terms + ("loss", "grad_norm")),
              f"uniflow fit records {records}")
        expected = {**{k: 0 for k in launches},
                    **{k: n * UNIFLOW_FIT_STEPS for k, n in per_step.items()}}
        check(launches == expected, f"uniflow fit launches {launches}, expected {expected}")
        check(len(memory.saves) == 1, f"{len(memory.saves)} checkpoint saves, expected one")
        emit({"phase": "uniflow_step_breakdown", **_uniflow_step_breakdown(
            fits.calls[0]["args"][0].exp, state, batch), "card": card})
        del state, model, fits
        torch.cuda.empty_cache()

        _reset_launches()
        t0 = time.perf_counter()
        with Spy(checkpoint.CheckpointManager, "load", replace=memory.load), \
                Spy(workloads.UniFlowRun, "validate") as validates, \
                Spy(checkpoint.CheckpointManager, "latest_step", replace=memory.latest_step):
            scores = cli.main(["validate", "-c", path, f"--ckpt_path={workdir}/checkpoints",
                               "--max_batches", "1"])
        torch.cuda.synchronize()
        validate_s = time.perf_counter() - t0
        val_launches = _uniflow_launches()
        panels = sorted(os.listdir(f"{workdir}/images"))
        pred_batch = config["data"]["pred_batch_size"]
        emit({"phase": "uniflow_validate", "config": UNIFLOW_CONFIG, "eval_images": evals,
              "batch": pred_batch, "image_size": 256, "canvas": 280,
              "validate_call_s": validate_s, "launches": val_launches, "scores": scores,
              "side_by_side_panels": len(panels), "card": card,
              "note": "one batch; FID with the seed-0 random Inception tower"})
        check({"metrics/psnr", "metrics/ssim", "metrics/fid"} <= set(scores) and all(
            np.isfinite(list(scores.values()))), f"uniflow validate scores {scores}")
        want = {**{k: 0 for k in val_launches}, "fwd": layers}
        check(val_launches == want, f"uniflow validate launches {val_launches}, want {want}")
        check(json.load(open(f"{workdir}/validate_metrics.json")) == scores,
              "validate_metrics.json")
        check(len(panels) == min(pred_batch, 16), f"side-by-side panels {len(panels)}")
        memory.files.clear()
        torch.cuda.empty_cache()

        # the semantic reconstruction of a validate batch, on the model the
        # validate built (its run object, kept by the Spy)
        run = validates.calls[0]["args"][0]
        gen = torch.Generator(device="cuda").manual_seed(seed)
        x = torch.rand(8, 224, 224, 3, generator=gen, device="cuda") * 2 - 1
        _reset_launches()
        tokens = run.exp.reconstruct(x, mode="semantic", generator=gen)
        torch.cuda.synchronize()
        sem_launches = _uniflow_launches()
        emit({"phase": "uniflow_semantic", "batch": 8, "shape": list(tokens.shape),
              "launches": sem_launches, "card": card})
        check(tuple(tokens.shape) == (8, 64, 4096) and bool(torch.isfinite(tokens).all()),
              f"semantic reconstruction {tuple(tokens.shape)}")
        check(sem_launches == {**{k: 0 for k in sem_launches}, "fwd": UNIFLOW_TOWER
                               + UNIFLOW_SHALLOW, "fwd_causal": UNIFLOW_TRUNK},
              f"semantic reconstruction launches {sem_launches}")
        del run, validates, tokens, x
        torch.cuda.empty_cache()

        shard = f"{UNIFLOW_DIR}/shards/shard-000000.tar"
        write_tar_shard(shard, seed + 2, count=32)
        rows = {}
        # whether the shipped 448 px batch fits is what uniflow_448 asks, so
        # "out of memory" is a reading there; uniflow_sem must run its step
        for name, cfg_path, may_overflow, want_step in (
                ("uniflow_448", UNIFLOW_448_CONFIG, True, per_step),
                ("uniflow_sem", UNIFLOW_SEM_CONFIG, False, {
                    "fwd_lse": UNIFLOW_TOWER + UNIFLOW_SHALLOW,
                    "bwd_dq": UNIFLOW_TOWER + UNIFLOW_SHALLOW,
                    "bwd_dkv": UNIFLOW_TOWER + UNIFLOW_SHALLOW,
                    "fwd_lse_causal": UNIFLOW_TRUNK, "bwd_dq_causal": UNIFLOW_TRUNK,
                    "bwd_dkv_causal": UNIFLOW_TRUNK})):
            one = f"{UNIFLOW_DIR}/{os.path.basename(cfg_path)}"
            oconfig = _write_uniflow_config(one, cfg_path, f"{UNIFLOW_DIR}/work_{name}", shard)
            row = _uniflow_one_step(one, card)
            node = oconfig["data"]["train_dataset"]["init_args"]
            if row["result"] == "fits":
                records, _, (row["step_s"],) = _fit_records(
                    f"{UNIFLOW_DIR}/work_{name}/{oconfig['tags']['exp']}")
                row["loss"] = records[0]["loss"]
            emit({"phase": name, "config": cfg_path, "batch": oconfig["data"]["train_batch_size"],
                  "image_size": node["resolution"], "random_crop": node.get("random_crop"),
                  "random_flip": node.get("random_flip"), **row})
            check(may_overflow or row["result"] == "fits", f"{name}: {row['error']}")
            if row["result"] == "fits":
                check(np.isfinite(row["loss"]), f"{name} loss {row['loss']}")
                check(row["launches"] == {**{k: 0 for k in row["launches"]}, **want_step},
                      f"{name} launches {row['launches']}")
            rows[name] = row
        return {"fit": launches, "validate": val_launches, "semantic": sem_launches,
                "448": rows["uniflow_448"], "sem": rows["uniflow_sem"], "per_step": per_step}
    finally:
        shutil.rmtree(UNIFLOW_DIR, ignore_errors=True)

def main() -> int:
    import torch

    if sys.argv[1:] == ["--calibrate-train-slice"]:
        calibrate_train_slice()  # on the CPU; sets no result
        return 2
    if sys.argv[1:] == ["--calibrate-t2i-slice"]:
        calibrate_t2i_slice()  # on the CPU; sets no result
        return 2
    if sys.argv[1:] == ["--calibrate-t2i-train-slice"]:
        calibrate_t2i_train_slice()  # on the CPU; sets no result
        return 2
    if sys.argv[1:] == ["--calibrate-c2i-families-slice"]:
        calibrate_families_slice()  # on the CPU; sets no result
        return 2
    if sys.argv[1:] == ["--calibrate-reco-slice"]:
        calibrate_reco_slice()  # on the CPU; sets no result
        return 2
    if sys.argv[1:] == ["--calibrate-vae-slice"]:
        calibrate_vae_slice()  # on the CPU; sets no result
        return 2
    if sys.argv[1:] == ["--calibrate-uniflow-slice"]:
        calibrate_uniflow_slice()  # on the CPU; sets no result
        return 2
    seed = int(sys.argv[sys.argv.index("--seed") + 1]) if "--seed" in sys.argv else 0
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the port on the card",
              file=sys.stderr)
        return 1
    if "--probe-families-memory" in sys.argv:
        probe_families_memory(seed)  # on the card; sets no result
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = phase_build()
    kernel = phase_kernel(card)
    train_errs, train_times = phase_kernels_train(card)
    model = phase_model()
    phase_slice()
    phase_train_slice()
    launches = phase_sample(model, card)
    del model
    torch.cuda.empty_cache()
    train_launches = phase_train(card)
    cli_launches = phase_cli(card, seed)
    torch.cuda.empty_cache()
    cli_512_launches = phase_cli_512(card, seed)
    torch.cuda.empty_cache()
    t2i_kernel = phase_t2i_kernel(card)
    phase_t2i_slice()
    t2i_serve_launches = phase_t2i_serve(card)
    t2i_predict_launches = phase_t2i_predict(card)
    torch.cuda.empty_cache()
    t2i_train = phase_t2i_train_kernels(card)
    phase_t2i_train_slice()
    t2i_fit_launches = phase_t2i_fit(card, seed)
    torch.cuda.empty_cache()
    fp32 = phase_fp32_attention(card)
    phase_families_slice()
    families = phase_baseline_fit(card, seed)
    torch.cuda.empty_cache()
    families["others"] = phase_families_fit(card, seed)
    torch.cuda.empty_cache()
    reco_kernels = phase_reco_kernels(card)
    phase_reco_slice()
    torch.cuda.empty_cache()
    reco = phase_reco(card, seed)
    torch.cuda.empty_cache()
    vae_kernels = phase_vae_kernels(card)
    phase_vae_slice()
    torch.cuda.empty_cache()
    vae = phase_vae(card, seed)
    torch.cuda.empty_cache()
    uniflow_kernels = phase_uniflow_kernels(card)
    phase_uniflow_slice()
    torch.cuda.empty_cache()
    uniflow = phase_uniflow(card, seed)
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    n1024 = {"fwd": kernel["n1024"], "fwd_lse": train_times.get("fwd_lse_512"),
             "bwd_dq": train_times.get("bwd_dq_512"), "bwd_dkv": train_times.get("bwd_dkv_512")}

    def row(name, source, replaces, launches, err, timing):
        key = {"flash_attention_fwd": "fwd"}.get(name, name.replace("flash_attention_", ""))
        path = "predict" if key == "fwd" else "fit"
        extra = {}
        if n1024.get(key):  # the 512 px shape, N = 1024
            extra["n1024"] = {k: v for k, v in n1024[key].items() if k in keys + (
                "library_backend", "whole_backward_ms", "sdpa_backward_ms",
                "sdpa_backward_backend")}
        return {"name": name, "route": "cuda", "source": f"deco_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": launches, "max_abs_err": err,
                f"cli_{path}_launches": cli_launches[path][key],
                f"cli_512_{path}_launches": cli_512_launches[path][key],
                **{k: timing[k] for k in keys},
                "library_backend": timing.get("library_backend"),
                **{k: v for k, v in timing.items()
                   if k.endswith("backward_ms") or k == "sdpa_backward_backend"}, **extra}

    fwd = row("flash_attention_fwd", "flash_attention_fwd.cu",
              "deco_tpu/ops/flash_attention.py:63", launches,
              max(kernel["max_abs_err"], t2i_kernel["max_abs_err"], reco_kernels["errs"]["fwd"],
                  vae_kernels["errs"]["fwd"]), kernel)
    # DeCo-XXL/16 t2i (D = 64): launches per serve and per CLI predict call
    # (the Pipeline of 2 prompts, one batch of 8), and the times at its shapes
    fwd.update(t2i_serve_launches=t2i_serve_launches,
               t2i_predict_launches=t2i_predict_launches,
               d64={name: {k: v for k, v in t.items() if k in keys + (
                   "library_backend", "b_nq_nkv_h_d", "max_abs_err")}
                   for name, t in t2i_kernel["timings"].items()})
    training = []
    for key, source, line in (("fwd_lse", "flash_attention_fwd.cu", 270),
                              ("bwd_dq", "flash_attention_bwd.cu", 344),
                              ("bwd_dkv", "flash_attention_bwd.cu", 379)):
        r = row(f"flash_attention_{key}", source, f"deco_tpu/ops/flash_attention.py:{line}",
                train_launches[key], max(train_errs[key], t2i_train["errs"][key],
                                         reco_kernels["errs"][key], vae_kernels["errs"][key]),
                train_times[key])
        # DeCo-XXL/16 t2i training (D = 64): launches in the 3-step CLI fit, and
        # the times at its joint, ragged and text shapes
        r.update(t2i_fit_launches=t2i_fit_launches["fit"][key],
                 baseline_fit_launches=families["fit"][key],
                 t2i={name: {k: v for k, v in t.items() if k in keys + (
                     "library_backend", "whole_backward_ms", "sdpa_backward_ms",
                "sdpa_backward_backend")}
                     for name, t in t2i_train["timings"][key].items()})
        # ReCo (ReCo_large.yaml): launches in the 3-step CLI fit and the
        # 448 px step, and the times at the tower's and the decoder's shapes
        r.update(reco_fit_launches=reco["fit"][key],
                 reco_448_step_launches=reco["stage3"]["launches"][key],
                 reco=_reco_timing_rows(reco_kernels["timings"][key], keys))
        # the VAE-GAN (vae_training_stage2_224.yaml, D = 32 in the decoder):
        # launches in the 3-step CLI fit, the step with the discriminator
        # started and the 448 px step, and the times at the D = 32 shapes
        # UniFlow (uniflow_internvit_2b_base.yaml): the non-causal launches in
        # the 3-step CLI fit, the 448 px and the semantic-AE steps
        r.update(uniflow_fit_launches=uniflow["fit"][key],
                 uniflow_448_step_launches=uniflow["448"]["launches"][key],
                 uniflow_sem_step_launches=uniflow["sem"]["launches"][key])
        r.update(vae_fit_launches=vae["fit"][key],
                 vae_fit_launches_per_step=vae["per_step"][key],
                 vae_disc_start_step_launches=vae["disc_start"][key],
                 vae_448_step_launches=vae["448"]["launches"][key],
                 d32=_reco_timing_rows(vae_kernels["timings"][key], keys + ("plain_b",)))
        training.append(r)
    fwd.update(baseline_predict_launches=families["predict"]["fwd"],
               reco_validate_launches=reco["validate"]["fwd"],
               reco=_reco_timing_rows(reco_kernels["timings"]["fwd"], keys),
               vae_validate_launches={r: v["fwd"] for r, v in vae["validate"].items()},
               dcae_eval_launches=vae["dcae_eval"]["fwd"],
               uniflow_validate_launches=uniflow["validate"]["fwd"],
               uniflow_semantic_launches=uniflow["semantic"]["fwd"],
               d32=_reco_timing_rows(vae_kernels["timings"]["fwd"], keys + ("plain_b",)))
    d32_resources = {name: {k: info[k] for k in ("registers", "local_bytes", "dynamic_smem",
                                                 "ctas_per_sm")}
                     for name, info in vae_kernels["resources"].items()
                     if name != "flash_fwd_f32_kernel"}
    for r in (fwd, *training):
        kind = {"flash_attention_fwd": "flash_fwd_kernel",
                "flash_attention_fwd_lse": "flash_fwd_kernel_lse",
                "flash_attention_bwd_dq": "flash_bwd_dq_kernel",
                "flash_attention_bwd_dkv": "flash_bwd_dkv_kernel"}[r["name"]]
        r["d32_resources"] = d32_resources[kind]
    # the fp32 kernel (3xTF32; the DINOv2 tower at D = 64, the DC-AE at
    # D = 32): launches in the Baseline-DiT fit, times at B*H 384 (one
    # microbatch) against both bounds, every other shape beside it
    f32_keys = keys + ("bound_3xtf32_ms", "bound_3xtf32_by")
    f32 = {"name": "flash_attention_fwd_f32", "route": "cuda",
           "source": "deco_tpu_torch/csrc/flash_attention_fwd.cu",
           "replaces": "deco_tpu/ops/flash_attention.py:63",
           "launches": families["fit"]["fwd_f32"], "max_abs_err": fp32["max_abs_err"],
           **{k: fp32[k] for k in f32_keys}, "library_backend": fp32.get("library_backend"),
           "library_note": "fp32 SDPA, a yardstick",
           "bound_note": "bound_ms at the fp32 SIMT rate; bound_3xtf32_ms: 3 x the "
                         "operations at the TF32 tensor-core rate, or the bytes",
           "b_n_h_d": fp32["b_n_h_d"], "head_dims": [32, 64],
           "other_shapes": {name: {k: t[k] for k in f32_keys + ("b_n_h_d", "library_backend")}
                            for name, t in fp32["timings"].items()},
           "resources": {d: {"registers": r["runtime"]["registers"],
                             "spill_store_bytes": r["ptxas"][0]["spill_store_bytes"],
                             "ctas_per_sm": r["runtime"]["ctas_per_sm"]}
                         for d, r in fp32["resources"].items()},
           "families_fit_launches": {p: r["fwd_f32"] for p, r in families["others"].items()}}
    # the causal instantiations (UniFlow's semantic trunk): launches on their
    # path (the fit for the training three, the semantic reconstruction for
    # the forward), times at the 224 px fit shape (16 x 64 tokens x 32
    # heads), every other shape beside it
    causal_rows = []
    for key, source, line in (("fwd", "flash_attention_fwd.cu", 63),
                              ("fwd_lse", "flash_attention_fwd.cu", 270),
                              ("bwd_dq", "flash_attention_bwd.cu", 344),
                              ("bwd_dkv", "flash_attention_bwd.cu", 379)):
        timing = uniflow_kernels["timings"][key]["n64"]
        kind = {"fwd": "flash_fwd_kernel_causal", "fwd_lse": "flash_fwd_kernel_lse_causal",
                "bwd_dq": "flash_bwd_dq_kernel_causal",
                "bwd_dkv": "flash_bwd_dkv_kernel_causal"}[key]
        causal_rows.append({
            "name": f"flash_attention_{key}_causal", "route": "cuda",
            "source": f"deco_tpu_torch/csrc/{source}",
            "replaces": f"deco_tpu/ops/flash_attention.py:{line}",
            "replaces_note": "its causal instantiation: the JAX package sends the masked call "
                             "to XLA (deco_tpu/models/layers.py:503-521)",
            "launches": (uniflow["semantic"] if key == "fwd" else uniflow["fit"])[
                f"{key}_causal"],
            "max_abs_err": uniflow_kernels["errs"][key],
            **({"max_err_scaled": uniflow_kernels["scaled"][key],
                "max_err_scaled_unit": "max(1, |plain|)"} if key in uniflow_kernels["scaled"]
               else {}),
            **{k: timing[k] for k in keys},
            "library_backend": timing.get("library_backend"),
            "library_note": "SDPA with is_causal, a yardstick",
            **{k: v for k, v in timing.items()
               if k.endswith("backward_ms") or k == "sdpa_backward_backend"},
            "b_nq_nkv_h_d": timing["b_nq_nkv_h_d"],
            "uniflow_448_step_launches": uniflow["448"]["launches"][f"{key}_causal"],
            "uniflow_sem_step_launches": uniflow["sem"]["launches"][f"{key}_causal"],
            "shapes": _reco_timing_rows(uniflow_kernels["timings"][key], keys),
            "resources": {k: uniflow_kernels["resources"][kind][k] for k in (
                "registers", "local_bytes", "dynamic_smem", "ctas_per_sm")}})
    emit({"kernels": [
        fwd, *training, f32, *causal_rows,
        row("freq_mse", "freq_mse.cu", "deco_tpu/ops/block_dct.py:175",
            train_launches["freq_mse"], train_errs["freq_mse"], train_times["freq_mse"]),
    ]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
