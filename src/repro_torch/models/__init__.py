"""Model layers and assembly on the paged KV layout (port of ``repro.models``)."""
