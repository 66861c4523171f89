"""Continuous-batching serving on the paged KV layout (port of ``repro.serving``)."""
