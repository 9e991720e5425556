from mlio_tpu.utils.device_utils import (
    calculate_memory_needed,
    clear_device_memory,
    device_info_string,
    enable_compile_cache,
    get_device_memory_usage,
    is_enough_device_memory,
)

__all__ = [
    "calculate_memory_needed",
    "clear_device_memory",
    "device_info_string",
    "enable_compile_cache",
    "get_device_memory_usage",
    "is_enough_device_memory",
]
