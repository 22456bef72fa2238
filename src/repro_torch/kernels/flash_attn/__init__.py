from repro_torch.kernels.flash_attn.ops import (flash_attention,  # noqa: F401
                                                flash_kernel)
from repro_torch.kernels.flash_attn.ref import flash_attn_ref  # noqa: F401
