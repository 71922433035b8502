"""Time one checkout's kernels on the card, to compare two.

    python deco_tpu_torch/time_kernels.py [--tree DIR] [--yardsticks] [--f32 | --d32]

Imports ``deco_tpu_torch`` from the checkout at ``DIR`` (default: the one
holding this file), builds its kernels there and prints one JSON line:

- the card's name and power limit;
- the median milliseconds, each call timed by CUDA events with L2 flushed
  before it (50 calls at N = 256, 10 at N = 4096), of
  - the forward ``flash_attention(q, k, v)`` at the sampling shape (B*H 256,
    N 256, D 72) and at N = 4096 (B*H 16);
  - the forward with lse ``flash_attention_fwd_lse`` at the training shape
    (B*H 512, N 256, D 72) and at N = 4096;
  - the whole backward ``flash_attention_bwd(q, k, v, o, lse, do, scale)``
    at the training shape and at N = 4096;
  - ``block_dct.freq_mse`` at (32, 256, 256, 3);
- with ``--l2-states``, ``freq_mse`` and ``diff.sum()`` (PyTorch's reduction,
  one read of the same 25 MB: what reading that input costs a library
  kernel) after an L2 flush that leaves L2 full of dirty lines (a write,
  as above) and after one that leaves it full of clean lines (a read), and
  an empty pair of events (the timer's own cost);
- with ``--yardsticks``, each SDPA backend's forward at the four forward
  rows (``chip_smoke.sdpa_forward_yardsticks``; the port never calls SDPA);
- with ``--f32``, in place of the rows above, the fp32 forward
  ``flash_attention_fwd_f32`` at the DINOv2 tower's shapes (B*H 384 and
  1,536 at N 257, B*H 192 at N 1,025, D 64) and, where the checkout takes
  D = 32, at the DC-AE's (N 64, 256, 1,024 and 4,096), each with its max
  error against the plain version over max|v| (20-30 calls a shape);
- with ``--d32``, in place of the rows above, the bf16 kernels at D = 32,
  the DC-AE decoder's attention in the VAE-GAN (:data:`D32`: the 224 px fit
  shapes at batch 8, the ragged 256 px validate shapes, N = 4,096): the
  forward, the forward with lse and the whole backward, where the checkout
  takes D = 32 (20-30 calls a shape);
- each kernel of the two attention sources and of ``freq_mse.cu``: its
  registers, spills and static shared memory from that checkout's build log,
  and its dynamic shared memory and resident CTAs per SM from the CUDA
  runtime where the checkout reports them, else the CTAs computed from the
  registers and static shared memory (``resident_ctas``).

Only those functions are called, whose signatures are the same in every
version of the port, so two checkouts compare on one card in one call, in
turns:

    for t in OLD . . OLD; do python deco_tpu_torch/time_kernels.py --tree $t; done
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

SAMPLING = (16, 256, 256, 16, 72)  # B, Nq, Nkv, H, D: DeCo-XL/16 256 px, CFG at batch 8
TRAINING = (32, 256, 256, 16, 72)  # the same at training batch 32
LONG = (1, 4096, 4096, 16, 72)  # N = 4096, the JAX streaming variants
F32 = {  # B, N, H, D: the DINOv2 tower at 256 px (x1, x4) and 512 px; the DC-AE
    "dinov2_256": (32, 257, 12, 64), "dinov2_256_x4": (128, 257, 12, 64),
    "dinov2_512": (16, 1025, 12, 64), "dcae_64": (8, 64, 32, 32),
    "dcae_256": (8, 256, 32, 32), "dcae_1024": (8, 1024, 16, 32),
    "dcae_4096": (2, 4096, 16, 32)}
D32 = {  # B, Nq, Nkv, H, D: the DC-AE decoder's three attention stages in the VAE-GAN
    "dcae_64": (8, 64, 64, 32, 32), "dcae_256": (8, 256, 256, 32, 32),
    "dcae_1024": (8, 1024, 1024, 16, 32), "dcae_100": (4, 100, 100, 32, 32),
    "dcae_400": (4, 400, 400, 32, 32), "dcae_1600": (4, 1600, 1600, 16, 32),
    "dcae_4096": (2, 4096, 4096, 16, 32)}
FREQ = (32, 256, 256, 3)


def resident_ctas(registers: int, smem_bytes: int, threads: int = 128) -> int:
    """CTAs that fit on one H100 SM: 65,536 registers allocated per warp in
    units of 256, 228 KB of shared memory with 1 KB reserved per CTA, 2,048
    threads and 32 CTAs."""
    per_warp = -(-registers * 32 // 256) * 256
    by_registers = 65536 // (per_warp * (threads // 32))
    by_smem = 233472 // (smem_bytes + 1024)
    return min(by_registers, by_smem, 2048 // threads, 32)


def _own(relpath: str):
    """A module of the checkout that holds this file (not the timed one,
    which may predate it): ``chip_smoke.py`` and ``ops/_build.py``."""
    import importlib.util

    path = Path(__file__).resolve().parents[1] / relpath
    spec = importlib.util.spec_from_file_location(f"_own_{path.stem}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def time_f32(result: dict, fa, cuda_ms, gen, flush) -> None:
    """The fp32 forward's median ms and max error over max|v| at each
    shape of :data:`F32` that the checkout takes."""
    import torch

    for row, (b, n, h, d) in F32.items():
        if d not in fa.F32_HEAD_DIMS:
            continue
        q, k, v = (torch.randn((b, n, h, d), generator=gen, device="cuda") for _ in range(3))
        scale = d ** -0.5
        err = (fa.flash_attention_fwd_f32(q, k, v, scale)
               - fa.flash_attention_plain(q, k, v, scale)).abs().max().item()
        result[row] = {"b_n_h_d": [b, n, h, d], "rel_err": err / v.abs().max().item(),
                       "ms": cuda_ms(lambda: fa.flash_attention_fwd_f32(q, k, v, scale),
                                     20 if n > 512 else 30, flush)}
        del q, k, v


def time_d32(result: dict, fa, cuda_ms, gen, flush) -> None:
    """The bf16 kernels' median ms at each shape of :data:`D32`, where the
    checkout takes D = 32."""
    import torch

    if 32 not in fa.SUPPORTED_HEAD_DIMS:
        return
    for row, (b, nq, nkv, h, d) in D32.items():
        q, do = (torch.randn((b, nq, h, d), generator=gen, device="cuda").bfloat16()
                 for _ in range(2))
        k, v = (torch.randn((b, nkv, h, d), generator=gen, device="cuda").bfloat16()
                for _ in range(2))
        scale = d ** -0.5
        o, lse = fa.flash_attention_fwd_lse(q, k, v, scale)
        iters = 20 if nq > 512 else 30
        result[row] = {
            "b_nq_nkv_h_d": [b, nq, nkv, h, d],
            "fwd_ms": cuda_ms(lambda: fa.flash_attention(q, k, v, scale), iters, flush),
            "fwd_lse_ms": cuda_ms(lambda: fa.flash_attention_fwd_lse(q, k, v, scale), iters,
                                  flush),
            "whole_backward_ms": cuda_ms(
                lambda: fa.flash_attention_bwd(q, k, v, o, lse, do, scale), iters, flush)}
        del q, k, v, do, o, lse


def time_bf16(result: dict, fa, block_dct, smoke, gen, flush, args) -> None:
    """The bf16 attention forward and backward rows and the frequency MSE,
    with the SDPA yardsticks and the L2 states where ``args`` asks."""
    import torch

    cuda_ms = smoke.cuda_ms

    def operands(b, nq, nkv, h, d):
        return [torch.randn(s, generator=gen, device="cuda").to(torch.bfloat16)
                for s in ((b, nq, h, d), (b, nkv, h, d), (b, nkv, h, d), (b, nq, h, d))]

    for row, shape, with_lse in (("fwd_sampling", SAMPLING, False), ("fwd_long", LONG, False),
                                 ("fwd_lse_training", TRAINING, True),
                                 ("fwd_lse_long", LONG, True)):
        q, k, v, _ = operands(*shape)
        scale = shape[-1] ** -0.5
        iters = 10 if shape is LONG else 50
        if with_lse:
            ms = cuda_ms(lambda: fa.flash_attention_fwd_lse(q, k, v, scale), iters, flush)
        else:
            ms = cuda_ms(lambda: fa.flash_attention(q, k, v), iters, flush)
        result[row] = {"b_nq_nkv_h_d": list(shape), "ms": ms}
        if args.yardsticks:
            result[row].update(smoke.sdpa_forward_yardsticks(q, k, v, scale, with_lse, flush,
                                                             iters))
        del q, k, v

    for row, shape in (("bwd_training", TRAINING), ("bwd_long", LONG)):
        q, k, v, do = operands(*shape)
        scale = shape[-1] ** -0.5
        o, lse = fa.flash_attention_fwd_lse(q, k, v, scale)
        iters = 10 if shape is LONG else 50
        result[row] = {"b_nq_nkv_h_d": list(shape), "whole_backward_ms": cuda_ms(
            lambda: fa.flash_attention_bwd(q, k, v, o, lse, do, scale), iters, flush)}
        del q, k, v, do, o, lse

    diff = torch.randn(FREQ, generator=gen, device="cuda")
    w = block_dct.build_freq_weight()
    result["freq_mse"] = {"shape": list(FREQ),
                          "ms": cuda_ms(lambda: block_dct.freq_mse(diff, w), 50, flush)}
    if args.l2_states:
        for state, before in (("dirty", flush.zero_), ("clean", flush.sum)):
            result["freq_mse"][state] = {
                "freq_mse_ms": cuda_ms(lambda: block_dct.freq_mse(diff, w), 50, before),
                "diff_sum_ms": cuda_ms(diff.sum, 50, before),
                "empty_ms": cuda_ms(lambda: None, 50, before)}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", default=str(Path(__file__).resolve().parents[1]))
    parser.add_argument("--yardsticks", action="store_true",
                        help="also time each SDPA backend at the forward rows")
    parser.add_argument("--f32", action="store_true",
                        help="time the fp32 forward instead of the bf16 kernels")
    parser.add_argument("--d32", action="store_true",
                        help="time the bf16 kernels at D = 32 instead of the rows above")
    parser.add_argument("--l2-states", action="store_true",
                        help="also time freq_mse and diff.sum() after a dirty and a clean flush")
    args = parser.parse_args()
    tree = Path(args.tree).resolve()
    sys.path[0] = str(tree)  # import that checkout's package, not this one's

    import torch

    from deco_tpu_torch._device import card_info
    from deco_tpu_torch.ops import _build, block_dct
    from deco_tpu_torch.ops import flash_attention as fa

    if not torch.cuda.is_available():
        print("time_kernels: no CUDA device", file=sys.stderr)
        return 1
    _build.build()
    smoke = _own("chip_smoke.py")
    cuda_ms = smoke.cuda_ms
    gen = torch.Generator(device="cuda").manual_seed(5)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")  # > the 50 MB L2
    result = {"tree": str(tree), "card": card_info(), "l2": "flushed before each call"}

    if args.f32:
        torch.backends.cuda.matmul.allow_tf32 = False  # the plain version in full fp32
        time_f32(result, fa, cuda_ms, gen, flush)
    elif args.d32:
        time_d32(result, fa, cuda_ms, gen, flush)
    else:
        time_bf16(result, fa, block_dct, smoke, gen, flush, args)

    runtimes = {"flash_attention_fwd": getattr(fa, "forward_kernel_info", None),
                "flash_attention_bwd": getattr(fa, "backward_kernel_info", None),
                "freq_mse": getattr(block_dct, "kernel_info", None)}
    kernels = []
    for source, runtime in runtimes.items():
        for row in smoke.kernel_resources(_build.BUILD_DIR, source, runtime):
            ptxas, rt = row["ptxas"], row["runtime"]
            if rt is None and source.startswith("flash"):  # 128 threads in every version
                row["ctas_per_sm_computed"] = resident_ctas(ptxas["registers"],
                                                            ptxas["static_smem"])
            kernels.append(row)
    result["kernels"] = kernels
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
