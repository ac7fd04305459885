from action_conditioned_gans_tpu_torch.models.discriminator import Discriminator  # noqa: F401
from action_conditioned_gans_tpu_torch.models.generator import Generator  # noqa: F401
