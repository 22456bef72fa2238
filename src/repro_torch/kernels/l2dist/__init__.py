from repro_torch.kernels.l2dist.ops import (  # noqa: F401
    l2_distances, l2_kernel, l2_plan)
from repro_torch.kernels.l2dist.ref import l2dist_ref  # noqa: F401
