"""``python -m fdoct_tpu_torch`` → the fdoct-torch CLI."""

import sys

if __name__ == "__main__":
    from fdoct_tpu_torch.cli import main

    sys.exit(main())
