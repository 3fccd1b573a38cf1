"""``flash_attention``'s share of its roofline in the chat cells' traced
prefills, in % (``readers.flash_attention_roofline``)."""

from readers import flash_attention_roofline as read  # noqa: F401
