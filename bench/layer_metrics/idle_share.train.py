"""Share of the training cell's traced window with no device operation, in %
(``readers.idle_share``)."""

from readers import idle_share as read  # noqa: F401
