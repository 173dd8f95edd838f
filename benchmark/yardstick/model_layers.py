"""The linear layers of the PINNSF mathematics at a configuration's widths.

One list serves the FLOP count (``flops.py``) and the seeded weights: each
layer is ``(name, in, out, rows)``, where ``rows`` says what the layer
runs over: ``"ped"`` (each agent's k1 neighbour edges), ``"obs"`` (its k2
obstacle edges) or ``"node"`` (each agent once).  Under the published
code's residual-block quirk (each block reads the original input, so only
the last block's output survives) the processor is one block of one
layer, whatever ``processor_hidden_layers`` says.
"""

from __future__ import annotations

from typing import List, Tuple

Layer = Tuple[str, int, int, str]


def layers(widths: dict) -> List[Layer]:
    enc, proc = widths["encoder_hidden_size"], widths["processor_hidden_size"]
    dec = widths["decoder_hidden_size"]
    bottleneck = widths["bottleneck"]
    out: List[Layer] = []
    for b, feat in (("ped", widths["ped_feature_dim"]),
                    ("obs", widths["obs_feature_dim"])):
        d = feat
        for i in range(widths["encoder_hidden_layers"]):
            out.append((f"{b}_encoder.dense_{i}", d, enc, b))
            d = enc
        out.append((f"{b}_processor.block_0.MLP_0.dense_0", enc, proc, b))
        rows = b if bottleneck else "node"
        d = proc
        for i in range(widths["decoder_hidden_layers"]):
            out.append((f"{b}_decoder.dense_{i}", d, dec, rows))
            d = dec
        out.append((f"{b}_predictor.dense_0", dec, 2, rows))
    head = widths.get("collision_head")
    if head:
        src = dec if head == "decoder" else (2 if bottleneck else proc)
        out.append(("collision_head.dense_0", src, dec, "ped"))
        out.append(("collision_head.dense_1", dec, 1, "ped"))
    return out
