"""Training batches over windowed scenes.

Counterpart of ``channel_batches`` in ``piml_tpu/data/datasets.py``
(reference: src/utils/data_loader.py:41-53).  The JAX package's
``stacked_channel_batches`` exists only to feed its finetune epoch, one
``lax.scan`` over stacked batches; the port's trainer loops over this
list in Python instead, so it has no counterpart here.
"""

from __future__ import annotations

from typing import List

import numpy as np

from piml_tpu_torch.data.views import ChanneledData


def channel_batches(data: List[ChanneledData], batch_size: int,
                    rng: np.random.RandomState,
                    shuffle: bool = False) -> List[ChanneledData]:
    """``batch_size``-window batches of every scene, the last partial one
    dropped; with ``shuffle`` the windows are drawn in the order of one
    ``rng.permutation`` per scene, as the JAX package draws them."""
    out = []
    for d in data:
        n = d.num_channels
        order = rng.permutation(n) if shuffle else np.arange(n)
        for i in range(n // batch_size):
            out.append(d.slice_channels(
                order[i * batch_size:(i + 1) * batch_size]))
    return out
