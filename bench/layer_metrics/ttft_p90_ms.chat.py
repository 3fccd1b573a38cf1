"""The chat cell's time to first token at the 90th percentile, over every
request submitted in the traced run's window, in ms: a closed loop of 32
clients on 32 slots runs at its capacity, so its tails swing with the host
and are read here rather than bounded (its rate is the bounded metric)."""

from readers import tail

read = tail("ttft_p90_ms")
