"""Cross-cutting utilities: serving metrics."""
