"""Utilities of the port: the file cache, figure saving, stage timing."""

from fm_returnprediction_tpu_torch.utils.cache import (
    cache_filename,
    file_cached,
    flatten_dict_to_str,
    hash_cache_filename,
    load_cache_data,
    read_cached_data,
    save_cache_data,
    write_cache_data,
)
from fm_returnprediction_tpu_torch.utils.figures import save_figure
from fm_returnprediction_tpu_torch.utils.timing import StageTimer, stage

__all__ = [
    "cache_filename",
    "file_cached",
    "flatten_dict_to_str",
    "hash_cache_filename",
    "load_cache_data",
    "read_cached_data",
    "save_cache_data",
    "write_cache_data",
    "save_figure",
    "StageTimer",
    "stage",
]
