"""Host-side data: Mega-NeRF ray generation, per-image metadata, and the
training datasets (chunked filesystem and in-memory)."""
