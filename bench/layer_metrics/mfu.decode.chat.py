"""The chat cells' decode steps' share of the card's peak, in %
(``readers.mfu_decode``)."""

from readers import mfu_decode as read  # noqa: F401
