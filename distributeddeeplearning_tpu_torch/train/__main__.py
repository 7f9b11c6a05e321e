"""``python -m distributeddeeplearning_tpu_torch.train``: see train/cli.py."""

import sys

from distributeddeeplearning_tpu_torch.train.cli import main

if __name__ == "__main__":
    sys.exit(main())
