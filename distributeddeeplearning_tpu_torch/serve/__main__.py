"""``python -m distributeddeeplearning_tpu_torch.serve``: see serve/cli.py."""

import sys

from distributeddeeplearning_tpu_torch.serve.cli import main

if __name__ == "__main__":
    sys.exit(main())
