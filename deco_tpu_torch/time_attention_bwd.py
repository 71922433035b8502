"""Time one checkout's flash-attention backward on the card, to compare two.

    python deco_tpu_torch/time_attention_bwd.py [--tree DIR]

Imports ``deco_tpu_torch`` from the checkout at ``DIR`` (default: the one
holding this file), builds its kernels there and prints one JSON line:

- the card's name and power limit;
- at the training shape (B*H 512, N 256, D 72) and at N = 4096 (B*H 16),
  the median milliseconds of the whole backward
  ``flash_attention_bwd(q, k, v, o, lse, do, scale)`` and, as a control
  that neither design changes, of ``flash_attention_fwd_lse``; where the
  checkout's dQ kernel computes delta (it has ``backward_kernel_info``),
  also of the dQ and dK/dV kernels apart; each call timed by CUDA events
  with L2 flushed before it (50 calls at the training shape, 10 at N = 4096);
- each backward kernel's registers, spills and static shared memory from
  that checkout's build log, and its resident CTAs per SM: from the CUDA
  runtime where the checkout reports it, else computed from the registers
  and shared memory (``resident_ctas``).

Only those two functions are called, whose signatures are the same in
every version of the port's backward, so two checkouts compare on one card
in one call, in turns:

    for t in OLD . . OLD; do python deco_tpu_torch/time_attention_bwd.py --tree $t; done
"""

from __future__ import annotations

import argparse
import json
import re
import sys
from pathlib import Path

SHAPES = {"train": (32, 256, 256, 16, 72), "long": (1, 4096, 4096, 16, 72)}  # B, Nq, Nkv, H, D


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
    which may predate it): ``chip_smoke.py``'s ``cuda_ms`` and
    ``_build.py``'s ``ptxas_report``."""
    import importlib.util

    path = Path(__file__).resolve().parents[1] / relpath
    spec = importlib.util.spec_from_file_location(f"_own_{path.stem}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", default=str(Path(__file__).resolve().parents[1]))
    args = parser.parse_args()
    tree = Path(args.tree).resolve()
    sys.path[0] = str(tree)  # import that checkout's package, not this one's

    import torch

    from deco_tpu_torch._device import card_info
    from deco_tpu_torch.ops import _build
    from deco_tpu_torch.ops import flash_attention as fa

    if not torch.cuda.is_available():
        print("time_attention_bwd: no CUDA device", file=sys.stderr)
        return 1
    _build.build()
    cuda_ms = _own("chip_smoke.py").cuda_ms
    ptxas_report = _own("deco_tpu_torch/ops/_build.py").ptxas_report
    gen = torch.Generator(device="cuda").manual_seed(5)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")  # > the 50 MB L2
    result = {"tree": str(tree), "card": card_info(), "l2": "flushed before each call"}
    info = getattr(fa, "backward_kernel_info", None)
    for name, (b, nq, nkv, h, d) in SHAPES.items():
        q, k, v, do = (torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
                       for shape in ((b, nq, h, d), (b, nkv, h, d), (b, nkv, h, d), (b, nq, h, d)))
        scale = d ** -0.5
        o, lse = fa.flash_attention_fwd_lse(q, k, v, scale)
        iters = 50 if name == "train" else 10
        result[name] = {
            "b_nq_nkv_h_d": [b, nq, nkv, h, d],
            "fwd_lse_ms": cuda_ms(lambda: fa.flash_attention_fwd_lse(q, k, v, scale), iters, flush),
            "whole_backward_ms": cuda_ms(lambda: fa.flash_attention_bwd(q, k, v, o, lse, do, scale),
                                         iters, flush)}
        if info is not None:
            _, delta = fa.flash_attention_bwd_dq(q, k, v, o, lse, do, scale)
            result[name].update(
                dq_ms=cuda_ms(lambda: fa.flash_attention_bwd_dq(q, k, v, o, lse, do, scale),
                              iters, flush),
                dkv_ms=cuda_ms(lambda: fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale),
                               iters, flush))
            del delta
        del q, k, v, do, o, lse

    kernels = []
    log = (_build.BUILD_DIR / "flash_attention_bwd.log").read_text()
    for mangled, ptxas in ptxas_report(log).items():
        kernel, d = re.search(r"(flash_bwd_\w+?_kernel)ILi(\d+)E", mangled).groups()
        row = {"kernel": f"{kernel}<{d}>", **ptxas}
        if info is not None:
            runtime = info(int(d))[kernel]
            row.update(dynamic_smem=runtime["dynamic_smem"], ctas_per_sm=runtime["ctas_per_sm"],
                       ctas_per_sm_from="runtime")
            smem = runtime["dynamic_smem"] + ptxas["static_smem"]
        else:
            smem = ptxas["static_smem"]
        row["ctas_per_sm_computed"] = resident_ctas(ptxas["registers"], smem)
        kernels.append(row)
    result["backward_kernels"] = sorted(kernels, key=lambda r: r["kernel"])
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
