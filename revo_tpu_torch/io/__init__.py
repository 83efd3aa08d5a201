"""Synthetic RGB-D input (numpy)."""
