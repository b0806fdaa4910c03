"""``python -m datatunerx_tpu_torch.analysis`` == ``dtx-torch lint``."""

import sys

from datatunerx_tpu_torch.analysis.cli import main

if __name__ == "__main__":
    sys.exit(main())
