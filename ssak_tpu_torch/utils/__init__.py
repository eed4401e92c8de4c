from ssak_tpu_torch.utils.misc import get_cache_dir, hashmd5, save_source_dir, walk_files
from ssak_tpu_torch.utils.monitoring import device_memory_stats, logger, tic, toc

__all__ = [
    "get_cache_dir",
    "hashmd5",
    "save_source_dir",
    "walk_files",
    "tic",
    "toc",
    "logger",
    "device_memory_stats",
]
