"""Time the port's PNG decoder on the host, for one checkout.

    python deco_tpu_torch/time_png.py [--tree DIR] [--rounds N]

decodes ``tests/torch_png_fixtures/pil_RGB_512x512.png`` (a 512 x 512 RGB
file written by Pillow, whose encoder picks the Average and Paeth filters
on most rows) and every other fixture the checkout's decoder reads,
``--rounds`` times each with the decoder of the checkout at ``DIR`` (its
``deco_tpu_torch``, built at first use into ``DIR/build/``) on one thread,
and prints one JSON line: the 512 x 512 file's median ms, the median ms a
megapixel over the fixtures read, the fixtures the decoder refused, the
host CPU and the card. The time is the host's, not the card's. To compare
two checkouts, run them alternately in one call:

    for t in OLD . . OLD; do python deco_tpu_torch/time_png.py --tree $t; done
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

FIXTURES = Path(__file__).resolve().parents[1] / "tests" / "torch_png_fixtures"
LARGE = "pil_RGB_512x512.png"


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--tree", default=str(Path(__file__).resolve().parents[1]))
    parser.add_argument("--rounds", type=int, default=5)
    args = parser.parse_args()
    sys.path.insert(0, str(Path(args.tree).resolve()))
    import numpy as np

    from deco_tpu_torch.time_jpeg import host_cpu
    from deco_tpu_torch.utils import png

    blobs, pixels, refused = {}, {}, []
    t0 = time.perf_counter()
    for path in sorted(FIXTURES.glob("*.png")):
        data = path.read_bytes()
        try:
            pixels[path.name] = int(np.prod(png.decode(data).shape[:2]))
            blobs[path.name] = data
        except ValueError:  # a kind an older checkout's decoder refuses
            refused.append(path.name)
    first_s = time.perf_counter() - t0
    per_file = {name: [] for name in blobs}
    per_mp = []
    for _ in range(args.rounds):
        total = 0.0
        for name, data in blobs.items():
            t0 = time.perf_counter()
            png.decode(data)
            dt = time.perf_counter() - t0
            per_file[name].append(dt * 1e3)
            total += dt
        per_mp.append(total * 1e3 / (sum(pixels.values()) / 1e6))
    try:
        from deco_tpu_torch._device import card_info

        card = card_info()
    except Exception as err:  # noqa: BLE001 - a host without a card still times its CPU
        card = f"no card ({type(err).__name__})"
    print(json.dumps({
        "tree": args.tree, "decoder": png.__file__, "rounds": args.rounds,
        "ms_512x512": float(np.median(per_file[LARGE])),
        "ms_per_mp": float(np.median(per_mp)), "ms_per_mp_rounds": per_mp,
        "files_read": len(blobs), "refused": refused,
        "first_decodes_s_with_build": first_s, "host_cpu": host_cpu(), "card": card,
        "note": "host time, one thread"}))


if __name__ == "__main__":
    main()
