"""Run the five probes on the card, each at its script's defaults.

    python -m cmcfs_tpu_torch.probes [--only NAME] [--device cuda|cpu]
        [--reps R]

Exits non-zero when a kernel disagrees with its plain version, and when
CUDA is asked for (the default) and absent: it never falls back to the
CPU.
"""
from __future__ import annotations

import argparse
import sys

from ..device import get_device
from . import PROBES


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m cmcfs_tpu_torch.probes")
    ap.add_argument("--only", choices=sorted(PROBES), action="append",
                    help="run only this probe (repeatable)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reps", type=int, default=None,
                    help="timed calls a variant (default: each script's)")
    args = ap.parse_args(argv)
    try:
        get_device(args.device)
    except RuntimeError as e:
        print(f"probes: {e}", file=sys.stderr)
        return 2
    rc = 0
    for name, mod in PROBES.items():
        if args.only and name not in args.only:
            continue
        sub = ["--device", args.device]
        if args.reps is not None:
            sub += ["--reps", str(args.reps)]
        rc |= mod.main(sub)
    return rc


if __name__ == "__main__":
    sys.exit(main())
