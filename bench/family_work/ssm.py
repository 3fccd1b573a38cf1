"""Work of a Mamba2 stack from its configuration file's fields:
parameters, a chunked SSD prefill and a recurrent decode step.  Part of
the yardstick: ``bench/work.py`` finds this file by the family's name."""

from __future__ import annotations

from typing import Dict

from work import scan_work

__all__ = ["decode", "dims", "params", "prefill"]


def dims(c: Dict) -> Dict[str, int]:
    d_inner = c["expand"] * c["d_model"]
    h = d_inner // c["headdim"]
    n = c["d_state"]
    conv_dim = d_inner + 2 * c["ngroups"] * n
    d_proj = 2 * d_inner + 2 * c["ngroups"] * n + h
    return {"d_inner": d_inner, "h": h, "p": c["headdim"], "n": n,
            "conv_dim": conv_dim, "d_proj": d_proj, "k": c["d_conv"],
            "q": c["chunk_size"]}


def params(c: Dict) -> Dict[str, int]:
    """Parameters of a Mamba2 stack: in and out projections, the depthwise
    convolution, the per-head and per-channel vectors, the embeddings."""
    d = c["d_model"]
    s = dims(c)
    mats = d * s["d_proj"] + s["d_inner"] * d
    small = s["conv_dim"] * (s["k"] + 1) + 3 * s["h"] + s["d_inner"] + d
    m = c.get("pad_vocab_size_multiple", 1)
    embed = -(-c["vocab_size"] // m) * m * d      # the padded table
    heads = 1 if c["tie_embeddings"] else 2
    return {"layer_matmul": mats, "layer_small": small, "embed": embed,
            "heads": heads, "matmul": c["n_layer"] * mats,
            "total": c["n_layer"] * (mats + small) + heads * embed + d}


def prefill(c: Dict, b: int, s: int, lengths, itemsize: int = 2) -> Dict:
    """Work of a Mamba2 prefill of ``b`` rows padded to ``s`` positions,
    whose prompts are ``lengths`` long: the projections over the prompt
    tokens, and over the chunks each prompt fills the SSD's products: C·B
    over the causal (query, key) pairs of a chunk, their weighted sum of
    X, the chunk states, the inter-chunk output and the state scan.
    ``scan_*`` is the ``ssd_scan`` calls' work at the padded shape they
    are launched at, one a layer."""
    p = params(c)
    d = dims(c)
    q, h, hp, n = d["q"], d["h"], d["p"], d["n"]

    def ssd(length: int) -> int:
        full, rest = divmod(length, q)
        pairs = full * q * (q + 1) // 2 + rest * (rest + 1) // 2
        chunks = full + (rest > 0)
        return (2 * pairs * (n + h * hp) + 4 * length * h * hp * n
                + 2 * chunks * h * hp * n)

    flops = (2 * p["matmul"] * sum(lengths) + 2 * p["embed"] * len(lengths)
             + c["n_layer"] * sum(map(ssd, lengths)))
    scan = scan_work(b * h, -(-s // q), hp, n)
    return {"flops": flops, "bytes": itemsize * p["total"],
            "scan_flops": c["n_layer"] * scan[0], "scan_bytes": c["n_layer"] * scan[1]}


def decode(c: Dict, contexts, itemsize: int = 2) -> Dict:
    """Work of one recurrent decode step over one lane a position in
    ``contexts`` (the state does not grow with it): every weight read
    once, each lane's float32 state read and written, and the projections
    and state update per lane."""
    lanes = len(contexts)
    p = params(c)
    s_ = dims(c)
    state = s_["h"] * s_["p"] * s_["n"]
    flops = lanes * (2 * (p["matmul"] + p["embed"]) + c["n_layer"] * 6 * state)
    nbytes = (itemsize * p["total"]
              + lanes * c["n_layer"] * (2 * 4 * state
                                        + 2 * itemsize * (s_["k"] - 1) * s_["conv_dim"]))
    return {"flops": flops, "bytes": nbytes}
