import sys

from action_conditioned_gans_tpu_torch.cli import main

sys.exit(main())
