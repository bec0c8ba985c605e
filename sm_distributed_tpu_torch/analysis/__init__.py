"""Analysis tools of the port: ``profiling`` (on-demand device profiles
through ``torch.profiler``, behind ``GET /debug/profile``)."""
