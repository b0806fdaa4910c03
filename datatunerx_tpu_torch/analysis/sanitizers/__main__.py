"""``python -m datatunerx_tpu_torch.analysis.sanitizers`` == ``dtx-torch san``."""

import sys

from datatunerx_tpu_torch.analysis.sanitizers.cli import main

if __name__ == "__main__":
    sys.exit(main())
