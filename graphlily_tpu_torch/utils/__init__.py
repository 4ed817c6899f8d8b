from .profiling import PhaseTimer, sync, dispatch_floor_ms
