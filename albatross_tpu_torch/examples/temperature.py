"""The temperature-field example through the port.

    python -m albatross_tpu_torch.examples.temperature [--stations 120] [--device cpu]

The example lives in ``albatross_tpu_torch.temperature``; this module
gives it its place beside the other examples.
"""

import sys

from ..temperature import main

__all__ = ["main"]

if __name__ == "__main__":
    sys.exit(main())
