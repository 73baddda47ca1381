"""`python -m grove_tpu_torch.bench`: the command line of cli.py."""

import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())
