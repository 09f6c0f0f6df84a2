"""Drivers of the program's entries, one a traffic entry, found by name."""
