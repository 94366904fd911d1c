from .observability import (trace, annotate, device_memory_stats,
                            host_memory_stats,
                            Throughput, JsonlLogger)

__all__ = ["trace", "annotate", "device_memory_stats",
           "host_memory_stats", "Throughput",
           "JsonlLogger"]
