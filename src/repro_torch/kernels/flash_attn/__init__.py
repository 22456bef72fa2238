from repro_torch.kernels.flash_attn.ops import (  # noqa: F401
    flash_attention, flash_instance, flash_kernel, flash_width)
from repro_torch.kernels.flash_attn.ref import flash_attn_ref  # noqa: F401
