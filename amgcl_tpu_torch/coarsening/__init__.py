"""Coarsening policies (smoothed aggregation, host route)."""
