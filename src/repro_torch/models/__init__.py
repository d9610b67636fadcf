"""Model zoo of the port: the families ported so far (``dense``, ``ssm``)."""

from .model import Model

__all__ = ["Model"]
