from repro_torch.kernels.flash_attn.ops import (  # noqa: F401
    BWD_BF16_KEY, BWD_KEY, BwdPlan, FlashPlan, flash_attention,
    flash_attention_bwd, flash_bwd_plan, flash_bwd_width, flash_instance,
    flash_kernel, flash_plan, flash_width)
from repro_torch.kernels.flash_attn.ref import (  # noqa: F401
    flash_attn_bwd_ref, flash_attn_ref)
