"""Per-row random draws that a trace can keep: Philox-4x32-10 in tensor ops.

The served program (``serving.py``) draws its noise from a seed per row,
as the JAX package keys ``jax.random`` per row under ``vmap``. A
``torch.Generator`` is neither per row nor traceable, so this module
writes out Philox-4x32-10 (Salmon et al., "Parallel random numbers: as
easy as 1, 2, 3", SC'11; the generator behind cuRAND) in int64 tensor ops
masked to 32 bits. A draw is a function of its key, its counter and
nothing else, so the bits are the same on the CPU and on the card, and a
row's draws do not depend on the other rows of its batch.

  * the key is the row's 64-bit seed, split into two 32-bit words;
  * the counter is (element, row, stream, 0): ``element`` numbers the
    4-word blocks of one draw, ``row`` is 0 when every row has its own
    seed and the row's index when the rows share one, and ``stream``
    names the draw (the latent noise, the mixture component, the tokens);
  * uniforms are the top 23 bits of a word, centred: ``(2k + 1) 2^-24``,
    in (0, 1) and exact in f32;
  * normals come from Box-Muller, Gumbel noise from ``-log(-log(u))``, and
    a categorical draw at a tensor temperature from the Gumbel-max trick.

It cannot give the bits of ``jax.random``: the served outputs are held to
the draws' properties, not to JAX's draws.
"""

from __future__ import annotations

import math

import torch

__all__ = [
    "MASK32",
    "STREAM_Z",
    "STREAM_COMPONENT",
    "STREAM_TEXT",
    "philox4x32",
    "RowRng",
    "temperature_terms",
    "categorical",
]

MASK32 = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57  # the round multipliers
_W0, _W1 = 0x9E3779B9, 0xBB67AE85  # the key schedule's Weyl increments
ROUNDS = 10

# The streams of the served program's draws.
STREAM_Z, STREAM_COMPONENT, STREAM_TEXT = 0, 1, 2


def _mulhilo(m: int, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The high and low 32-bit words of ``m * x`` for a 32-bit constant
    ``m`` and int64 words ``x < 2^32``, without leaving int64: ``m`` is cut
    into 16-bit halves, so no partial product reaches 2^49."""
    p0 = x * (m & 0xFFFF)
    p1 = x * (m >> 16)
    s = p0 + ((p1 & 0xFFFF) << 16)
    return (p1 >> 16) + (s >> 32), s & MASK32


def philox4x32(
    c0: torch.Tensor, c1: torch.Tensor, c2: torch.Tensor, c3: torch.Tensor,
    k0: torch.Tensor, k1: torch.Tensor, rounds: int = ROUNDS,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Philox-4x32 of the counter words ``c0..c3`` under the key words
    ``k0, k1``: int64 tensors (or ints) of 32-bit words that broadcast
    together. Returns the four output words."""
    for r in range(rounds):
        if r:
            k0 = (k0 + _W0) & MASK32
            k1 = (k1 + _W1) & MASK32
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


class RowRng:
    """The random streams of a batch: a ``(B, 1)`` key per row and the
    ``(B, 1)`` row word of its counter.

    :meth:`from_seed` with ``per_row=True`` takes a ``(B,)`` seed per row
    (row word 0: a row's draws are a function of its seed alone); with
    ``per_row=False`` a 0-d seed that every row shares (row word the row's
    index). :meth:`prefetch` draws the words of several streams in one
    Philox evaluation (a traced program then holds one copy of its ten
    rounds, not one a draw); the later draws of those streams read them."""

    def __init__(self, key: torch.Tensor, row: torch.Tensor):
        self.key, self.row = key, row
        self._words: dict[int, torch.Tensor] = {}

    @classmethod
    def from_seed(cls, seed: torch.Tensor, n: int, per_row: bool) -> "RowRng":
        seed = seed.to(torch.int64)
        if per_row:
            key = seed.reshape(-1, 1)
            return cls(key, torch.zeros_like(key))
        row = torch.arange(n, device=seed.device, dtype=torch.int64)[:, None]
        return cls(seed.reshape(1, 1).expand(row.shape[0], 1), row)

    def prefetch(self, sizes: dict[int, int]) -> None:
        """Draw ``sizes[stream]`` words of each stream in one evaluation:
        the counters ``(block, row, stream, 0)`` of every stream's blocks
        side by side."""
        if not sizes:
            return
        streams = sorted(sizes)
        n_blocks = [-(-sizes[s] // 4) for s in streams]
        dev = self.key.device
        blocks = torch.tensor([j for nb in n_blocks for j in range(nb)], dtype=torch.int64,
                              device=dev)
        stream_of = torch.tensor([s for s, nb in zip(streams, n_blocks) for _ in range(nb)],
                                 dtype=torch.int64, device=dev)
        words = philox4x32(blocks[None], self.row, stream_of[None], 0, self.key & MASK32,
                           (self.key >> 32) & MASK32)
        words = torch.stack(torch.broadcast_tensors(*words), dim=-1)  # (B, blocks, 4)
        words = words.reshape(words.shape[0], -1)  # the 4 words of each block in turn
        at = 0
        for s, nb in zip(streams, n_blocks):
            self._words[s] = words[:, 4 * at:4 * at + sizes[s]]
            at += nb

    def bits(self, stream: int, n: int) -> torch.Tensor:
        """``(B, n)`` int64 words in [0, 2^32) of stream ``stream`` (drawn
        here unless :meth:`prefetch` drew as many)."""
        drawn = self._words.get(stream)
        if drawn is None or drawn.shape[1] < n:
            self.prefetch({stream: n})
        return self._words[stream][:, :n]

    def uniform(self, stream: int, n: int) -> torch.Tensor:
        """``(B, n)`` f32 uniforms in (0, 1): ``(2k + 1) 2^-24`` of the
        words' top 23 bits ``k``."""
        return ((self.bits(stream, n) >> 9) * 2 + 1).to(torch.float32) * 2.0**-24

    def normal(self, stream: int, n: int) -> torch.Tensor:
        """``(B, n)`` f32 standard normals by Box-Muller from ``2 ceil(n/2)``
        uniforms: the first half gives the radii, the second the angles;
        the cosines fill the first half of the normals, the sines the
        second."""
        half = -(-n // 2)
        u = self.uniform(stream, 2 * half)
        radius = torch.sqrt(-2.0 * torch.log(u[:, :half]))
        angle = (2.0 * math.pi) * u[:, half:]
        return torch.cat([radius * torch.cos(angle), radius * torch.sin(angle)], -1)[:, :n]

    def gumbel(self, stream: int, n: int) -> torch.Tensor:
        """``(B, n)`` f32 standard Gumbel noise, ``-log(-log(u))``."""
        return -torch.log(-torch.log(self.uniform(stream, n)))


def temperature_terms(temperature: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(t > 0, safe_t)`` of a 0-d temperature ``t``, ``safe_t = where(t > 0,
    t, 1)`` as the JAX decoder writes it: made once for a whole decode."""
    t = torch.as_tensor(temperature, dtype=torch.float32)
    return t > 0, torch.where(t > 0, t, torch.ones_like(t))


def categorical(
    logits: torch.Tensor, gumbel: torch.Tensor, terms: tuple[torch.Tensor, torch.Tensor]
) -> torch.Tensor:
    """Trace-safe token choice over the last dim, ``terms`` those of
    :func:`temperature_terms`: the Gumbel-max draw from ``softmax(logits /
    t)`` where ``t > 0``, the argmax where ``t <= 0`` (``where(t > 0,
    sampled, greedy)``)."""
    sample, safe_t = terms
    sampled = torch.argmax(logits / safe_t + gumbel, dim=-1)
    return torch.where(sample, sampled, torch.argmax(logits, dim=-1))
