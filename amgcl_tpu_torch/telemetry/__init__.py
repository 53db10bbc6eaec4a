"""Solve reports and numerical-health guards."""
