"""Time the port's JPEG decoder on the host, for one checkout.

    python deco_tpu_torch/time_jpeg.py [--tree DIR] [--rounds N]

decodes every fixture of ``tests/torch_jpeg_fixtures/`` ``--rounds`` times
with the decoder of the checkout at ``DIR`` (its ``deco_tpu_torch``, built
at first use into ``DIR/build/``) on one thread, and prints one JSON line:
the median ms a megapixel over the rounds, each fixture's median ms, the
host CPU and the card. The time is the host's, not the card's. To compare
two checkouts, run them alternately in one call:

    for t in OLD . . OLD; do python deco_tpu_torch/time_jpeg.py --tree $t; done
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

FIXTURES = Path(__file__).resolve().parents[1] / "tests" / "torch_jpeg_fixtures"


def host_cpu() -> str:
    """Vendor, family, model and model name of the first CPU (``/proc/cpuinfo``)."""
    fields = {}
    with open("/proc/cpuinfo") as f:
        for line in f:
            if not line.strip():
                break
            key, _, value = line.partition(":")
            fields[key.strip()] = value.strip()
    return (f"{fields.get('vendor_id', '?')} family {fields.get('cpu family', '?')} model "
            f"{fields.get('model', '?')} ({fields.get('model name', '?')})")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--tree", default=str(Path(__file__).resolve().parents[1]))
    parser.add_argument("--rounds", type=int, default=5)
    args = parser.parse_args()
    sys.path.insert(0, str(Path(args.tree).resolve()))
    import numpy as np

    from deco_tpu_torch.data import jpeg

    blobs = {p.name: p.read_bytes() for p in sorted(FIXTURES.glob("*.jpg"))}
    t0 = time.perf_counter()
    pixels = {name: np.prod(jpeg.decode(data).shape[:2]) for name, data in blobs.items()}
    first_s = time.perf_counter() - t0
    per_file = {name: [] for name in blobs}
    per_mp = []
    for _ in range(args.rounds):
        total = 0.0
        for name, data in blobs.items():
            t0 = time.perf_counter()
            jpeg.decode(data)
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
        "tree": args.tree, "decoder": jpeg.__file__, "rounds": args.rounds,
        "ms_per_mp": float(np.median(per_mp)), "ms_per_mp_rounds": per_mp,
        "ms_per_file": {k: float(np.median(v)) for k, v in per_file.items()},
        "first_decodes_s_with_build": first_s, "host_cpu": host_cpu(), "card": card,
        "note": "host time, one thread"}))


if __name__ == "__main__":
    main()
