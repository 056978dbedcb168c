"""The observability subset the unified serving path calls."""
