"""ns-process-data's `images` and `rgbt` converters (host-only)."""
