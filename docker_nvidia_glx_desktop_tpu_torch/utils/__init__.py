"""Utilities: config surface, math helpers, host colour conversion."""

from . import config  # noqa: F401
from .mathutil import cdiv, round_up  # noqa: F401
