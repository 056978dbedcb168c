"""Ops of the port: the ragged paged attention kernel and its plain twin,
the paged-pool bookkeeping, and in-step sampling."""
