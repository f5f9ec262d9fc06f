"""Run every example in turn, as the JAX package's ``ci/run_examples.sh``
does, each at its defaults.

    python -m albatross_tpu_torch.examples [--device cpu]
"""

import argparse
import importlib
import sys

EXAMPLES = ("sinc", "sparse", "inspection", "sampler", "temperature", "distributed", "accuracy")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default=None, help="cpu, or the card (the default)")
    args = parser.parse_args(argv)
    device = [] if args.device is None else ["--device", args.device]
    for name in EXAMPLES:
        print(f"=== albatross_tpu_torch.examples.{name} ===", flush=True)
        rc = importlib.import_module(f"albatross_tpu_torch.examples.{name}").main(device)
        if rc:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
