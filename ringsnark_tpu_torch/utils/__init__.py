"""Evaluation domains, polynomial helpers (list-based and array-path),
serialization, profiling, the threefry PRNG, and JAX-package interop."""
