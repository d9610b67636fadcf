"""Model zoo of the port: every family of the reference's zoo (``dense``,
``ssm``, ``moe``, ``hybrid``, ``encdec``, ``vlm``)."""

from .model import Model

__all__ = ["Model"]
