"""Batches over the host synthetic dataset (port of
`av_separation_tpu/data/loader.py`).

The dataset is materialised once into stacked NumPy arrays, then batches are
cut by shuffled index, as the reference's `DataLoader(batch_size=8,
shuffle=True)` (reference demo.py:87) does.  With the same seed the batches
are those of the JAX loader, batch for batch.
"""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np

from av_separation_torch.data.synthetic import SyntheticAVDataset


def batch_iterator(dataset: SyntheticAVDataset, batch_size: int,
                   seed: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """Shuffled full batches, reshuffled each epoch, forever (the JAX
    loader's defaults: `drop_last=True`, `loop=True`, `start_step=0`; resuming
    at a step comes with checkpointing)."""
    data = dataset.materialize()
    n = len(dataset)
    rng = np.random.default_rng(seed)
    while True:
        order = rng.permutation(n)
        for start in range(0, n - batch_size + 1, batch_size):
            idx = order[start:start + batch_size]
            yield {k: v[idx] for k, v in data.items()}


def eval_batch(dataset: SyntheticAVDataset,
               num_samples: int = 20) -> Dict[str, np.ndarray]:
    """The first `num_samples` samples stacked: the reference's eval subset
    (reference demo.py:43 uses min(20, len(ds)))."""
    data = dataset.materialize()
    n = min(num_samples, len(dataset))
    return {k: v[:n] for k, v in data.items()}
