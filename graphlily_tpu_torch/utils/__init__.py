from .profiling import span
