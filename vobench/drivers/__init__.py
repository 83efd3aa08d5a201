"""Drivers of the traffic mixes: ``<name>.py`` defines ``Driver(cell, seed,
device)``, which the traffic file names under ``driver``."""
