"""Host-side utilities (DNA encoding, device selection)."""
