"""Utilities: timing, events, map publishing, rendering."""
