"""Data constants."""
