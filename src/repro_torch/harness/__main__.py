"""``python -m repro_torch.harness`` — run the scenario sweep from the shell."""

import sys

from repro_torch.harness.cli import main

if __name__ == "__main__":
    sys.exit(main())
