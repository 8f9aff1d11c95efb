"""Continuous-batching serving: paged KV cache, scheduler, engine."""
