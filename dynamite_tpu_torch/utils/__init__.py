"""Host-side utilities: bit manipulation and validation."""
