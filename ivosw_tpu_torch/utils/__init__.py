from ivosw_tpu_torch.utils.misc import (
    AverageMeter,
    PhaseTimer,
    create_stream_logger,
    set_random_seed,
)

__all__ = [
    "AverageMeter",
    "PhaseTimer",
    "create_stream_logger",
    "set_random_seed",
]
