"""Prefill device time per padded prompt position in the docs cells' traced
window, in us (``readers.us_per_token``)."""

from readers import us_per_token as read  # noqa: F401
