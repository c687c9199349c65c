from .logger import close_logger, setup_logger  # noqa: F401
from .misc import (AverageMeter, BestRecorder, ProgressMeter, dump_config,  # noqa: F401
                   increment_path, prefetch_iter)
