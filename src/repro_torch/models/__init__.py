"""Model zoo of the port: the decoder-only families (``dense``, ``ssm``,
``moe``, ``hybrid``)."""

from .model import Model

__all__ = ["Model"]
