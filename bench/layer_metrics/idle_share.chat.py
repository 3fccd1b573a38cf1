"""Share of the chat cells' traced window with no device operation, in %
(``readers.idle_share``)."""

from readers import idle_share as read  # noqa: F401
