"""The docs cells' prefills' share of the card's peak, in %
(``readers.mfu``)."""

from readers import mfu as read  # noqa: F401
