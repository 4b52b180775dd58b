from .column import Column
from .chunk import Chunk
from .device import DeviceColumn, DeviceBatch, to_device_batch, to_stacked_device_batch, STRING_WORDS

__all__ = ["Column", "Chunk", "DeviceColumn", "DeviceBatch", "to_device_batch", "to_stacked_device_batch", "STRING_WORDS"]
