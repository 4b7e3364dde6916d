"""Configs of the port: the query service's `ServiceConfig`.

The JAX package's `configs` also holds LLM architecture fixtures that the
graph system never reaches; they are not ported.
"""
from .service import ServiceConfig

__all__ = ["ServiceConfig"]
