"""`python -m tendermint_tpu_torch <command>`: the CLI (cli.py)."""

import sys

from tendermint_tpu_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
