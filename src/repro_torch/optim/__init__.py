from repro_torch.optim.adamw import (  # noqa: F401
    OptimizerConfig,
    adamw_init,
    adamw_update,
    apply_updates,
    cosine_lr,
    global_norm,
)
from repro_torch.optim.compress import (  # noqa: F401
    compress_decompress,
    ef_compress_grads,
    ef_init,
)
