"""Parallelism of the port: data parallelism across processes (`mesh`)."""
