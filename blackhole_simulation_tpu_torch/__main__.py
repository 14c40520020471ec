"""``python -m blackhole_simulation_tpu_torch``: the CLI entry point."""

import sys

from blackhole_simulation_tpu_torch.app.cli import main

if __name__ == "__main__":
    sys.exit(main())
