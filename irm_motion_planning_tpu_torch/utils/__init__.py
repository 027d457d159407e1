from . import io, profiling, timing  # noqa: F401
