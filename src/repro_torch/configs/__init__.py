"""Language-model specs: importing this package registers them."""
from repro_torch.configs.base import LMSpec, get_arch, list_archs  # noqa: F401
from repro_torch.configs import phi4_mini_3_8b, smollm_135m  # noqa: F401
