"""The chat cell's inter-token gap at the 95th percentile, over every gap of
every request submitted in the traced run's window (the card's clock), in
ms; a per-layer reading for the reason ``ttft_p90_ms.chat`` gives."""

from readers import tail

read = tail("itl_p95_ms")
