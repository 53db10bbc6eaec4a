"""Sample problems and device selection."""
