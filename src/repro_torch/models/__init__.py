"""Model zoo: the execution substrate that AI Sessions bind to."""

from repro_torch.models.config import ModelConfig  # noqa: F401
from repro_torch.models.transformer import LM  # noqa: F401
