"""Host-side data: Mega-NeRF ray generation and per-image metadata."""
