"""``python -m datatunerx_tpu_torch.loadgen`` — the replay CLI."""

import sys

from datatunerx_tpu_torch.loadgen.replay import main

if __name__ == "__main__":
    sys.exit(main())
