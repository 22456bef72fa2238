from repro_torch.kernels.flash_attn.ops import (  # noqa: F401
    FlashPlan, flash_attention, flash_instance, flash_kernel, flash_plan,
    flash_width)
from repro_torch.kernels.flash_attn.ref import flash_attn_ref  # noqa: F401
