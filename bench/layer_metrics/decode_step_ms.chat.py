"""Mean device time of a decode step in the chat cells' traced window, in ms
(``readers.decode_step_ms``)."""

from readers import decode_step_ms as read  # noqa: F401
