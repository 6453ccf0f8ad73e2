"""``python -m horovod_tpu_torch.runner`` == the ``tpurun`` CLI."""

import sys

from .launch import main

if __name__ == "__main__":
    sys.exit(main())
