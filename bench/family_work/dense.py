"""Work of a dense GQA decoder (the LLaMA layout) from its configuration
file's fields: parameters, a causal prefill and a decode step.  Part of
the yardstick: ``bench/work.py`` finds this file by the family's name."""

from __future__ import annotations

from typing import Dict

from work import attention_work

__all__ = ["decode", "params", "prefill"]


def params(c: Dict) -> Dict[str, int]:
    """Parameters of a dense GQA decoder: one layer's matrices, the
    embedding table and the unembedding (untied), the norms; ``matmul`` is
    the layers' matrices, which every token passes through."""
    d, h, hkv, dh, f = (c["hidden_size"], c["num_attention_heads"],
                        c["num_key_value_heads"], c["head_dim"],
                        c["intermediate_size"])
    layer = d * h * dh * 2 + d * hkv * dh * 2 + 3 * d * f
    embed = c["vocab_size"] * d
    heads = 1 if c["tie_word_embeddings"] else 2
    norms = d * (2 * c["num_hidden_layers"] + 1)
    return {"layer": layer, "embed": embed, "heads": heads, "norms": norms,
            "matmul": c["num_hidden_layers"] * layer,
            "total": c["num_hidden_layers"] * layer + heads * embed + norms}


def prefill(c: Dict, b: int, s: int, lengths, itemsize: int = 2) -> Dict:
    """Work of a causal prefill of ``b`` rows padded to ``s`` positions,
    whose prompts are ``lengths`` long: the matrices over the prompt
    tokens, causal attention over each prompt, every weight read once.
    ``attn_*`` is the ``flash_attention`` calls' work at the padded shape
    they are launched at, one a layer."""
    p = params(c)
    layers, hq, hkv, dh = (c["num_hidden_layers"], c["num_attention_heads"],
                           c["num_key_value_heads"], c["head_dim"])
    # the logits of each prompt's last position only
    flops = 2 * p["matmul"] * sum(lengths) + 2 * p["embed"] * len(lengths)
    flops += layers * sum(4 * hq * dh * n * (n + 1) // 2 for n in lengths)
    attn = attention_work(b, hq, hkv, s, s, dh, True, None, itemsize)
    return {"flops": flops, "bytes": itemsize * p["total"],
            "attn_flops": layers * attn[0], "attn_bytes": layers * attn[1]}


def decode(c: Dict, contexts, itemsize: int = 2) -> Dict:
    """Work of one decode step over lanes at positions ``contexts`` (the
    number of cached keys each new token attends to, itself included):
    every weight read once, each lane's keys and values read once, two
    products of D per visible key and query head."""
    p = params(c)
    layers, hq, hkv, dh = (c["num_hidden_layers"], c["num_attention_heads"],
                           c["num_key_value_heads"], c["head_dim"])
    ctx = sum(contexts)
    flops = (2 * (p["matmul"] + p["embed"]) * len(contexts)
             + layers * 4 * hq * dh * ctx)
    nbytes = itemsize * p["total"] + layers * 2 * hkv * dh * itemsize * ctx
    return {"flops": flops, "bytes": nbytes}
