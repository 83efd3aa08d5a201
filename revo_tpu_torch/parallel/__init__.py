"""Whole-sequence VO (``batch``): the device-loop twin of system.VOSystem."""
