from .logger import close_logger, setup_logger  # noqa: F401
from .misc import AverageMeter, ProgressMeter, dump_config, increment_path, prefetch_iter  # noqa: F401
