import sys

from dtc_tpu_torch.utils.cli import main

if __name__ == "__main__":
    sys.exit(main())
