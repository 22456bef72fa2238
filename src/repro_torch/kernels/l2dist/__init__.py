from repro_torch.kernels.l2dist.ops import l2_distances  # noqa: F401
from repro_torch.kernels.l2dist.ref import l2dist_ref  # noqa: F401
