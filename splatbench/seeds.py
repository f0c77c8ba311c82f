"""Independent random streams derived from one ``--seed``.

Each consumer (the scene, the views, the sample of frames checked) takes its
own stream, so adding draws to one never shifts another.  Any whole number is
a seed: it is reduced modulo 2**64.
"""

from __future__ import annotations

import zlib

import numpy as np

STREAMS = ("scene", "views", "sample")


def sequence(seed: int, stream: str) -> np.random.SeedSequence:
    if stream not in STREAMS:
        raise ValueError(f"unknown stream {stream!r}: one of {STREAMS}")
    return np.random.SeedSequence([int(seed) % (1 << 64), zlib.crc32(stream.encode())])


def rng(seed: int, stream: str) -> np.random.Generator:
    return np.random.default_rng(sequence(seed, stream))


def torch_seed(seed: int, stream: str) -> int:
    """A seed for ``torch.Generator.manual_seed`` (below 2**63)."""
    return int(sequence(seed, stream).generate_state(1, np.uint64)[0] >> np.uint64(1))
