"""Replay buffer of partially-solved problems, port of
`helmnet_tpu/train/replay.py`.

Keeps the reference's indexed-slot semantics (replaybuffer.py:20-47: `append`
overwrites a given slot, `sample` draws uniformly without replacement and
returns the indices for write-back) in preallocated structure-of-arrays
numpy buffers on the host: one gather per field and sample (core/native.py)
and one upload per field to the card. The draws come from
`np.random.default_rng(seed)` exactly as in the JAX package, so both
packages sample the same slots.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from ..core.native import gather_rows


class ExperienceBatch(NamedTuple):
    """A batch of experiences: numpy arrays from `ReplayBuffer.sample`, or
    tensors on the trainer's device for a train step."""

    wavefield: np.ndarray  # [B, H, W, 2]
    states: np.ndarray  # [B, C, S] flat packed hidden states
    k_sq: np.ndarray  # [B, H, W]
    residual: np.ndarray  # [B, H, W, 2]
    source: np.ndarray  # [B, H, W, 2]
    iteration: np.ndarray  # [B] int32 solver-age of each experience
    indices: np.ndarray  # [B] slot indices (for write-back)


class ReplayBuffer:
    def __init__(
        self,
        capacity: int,
        height: int,
        width: int,
        state_channels: int,
        state_length: int,
        seed: int = 0,
    ):
        self.capacity = capacity
        shape = (capacity, height, width)
        self.wavefield = np.zeros(shape + (2,), np.float32)
        self.states = np.zeros((capacity, state_channels, state_length), np.float32)
        self.k_sq = np.zeros(shape, np.float32)
        self.residual = np.zeros(shape + (2,), np.float32)
        self.source = np.zeros(shape + (2,), np.float32)
        self.iteration = np.zeros(capacity, np.int32)
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return self.capacity

    def append_batch(
        self, indices, wavefield, states, k_sq, residual, source, iteration
    ) -> None:
        """Overwrite the given slots with new experiences (vectorized)."""
        idx = np.asarray(indices)
        self.wavefield[idx] = wavefield
        self.states[idx] = states
        self.k_sq[idx] = k_sq
        self.residual[idx] = residual
        self.source[idx] = source
        self.iteration[idx] = iteration

    def append(self, index, wavefield, states, k_sq, residual, source, iteration):
        self.append_batch(
            np.array([index]), wavefield[None], states[None], k_sq[None],
            residual[None], source[None], np.array([iteration]),
        )

    def sample(self, batch_size: int) -> ExperienceBatch:
        batch_size = min(batch_size, self.capacity)
        idx = self._rng.choice(self.capacity, batch_size, replace=False)
        return ExperienceBatch(
            wavefield=gather_rows(self.wavefield, idx),
            states=gather_rows(self.states, idx),
            k_sq=gather_rows(self.k_sq, idx),
            residual=gather_rows(self.residual, idx),
            source=gather_rows(self.source, idx),
            iteration=self.iteration[idx],
            indices=idx,
        )
