from repro_torch.train.loop import (  # noqa: F401
    TrainConfig, init_state, make_train_step, run)
from repro_torch.train import checkpoint  # noqa: F401
from repro_torch.train.fault import (  # noqa: F401
    FaultInjector,
    StepDeadline,
    StragglerTimeout,
    WorkerFailure,
    reshard_state,
    supervise,
)
