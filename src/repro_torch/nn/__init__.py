"""Model stack for paged serving."""
