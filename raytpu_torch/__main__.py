import sys

from raytpu_torch.cli import main

sys.exit(main())
