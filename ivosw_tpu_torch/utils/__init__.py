from ivosw_tpu_torch.utils.misc import (
    AverageMeter,
    PhaseTimer,
    create_stream_logger,
    profile_trace,
    rng_chain,
    set_random_seed,
)

__all__ = [
    "AverageMeter",
    "PhaseTimer",
    "create_stream_logger",
    "profile_trace",
    "rng_chain",
    "set_random_seed",
]
