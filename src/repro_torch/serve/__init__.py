"""Continuous-batching serving engine and its scheduler."""
