"""Smoothers."""
