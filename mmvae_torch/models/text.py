"""Sequence (text / digit-string) experts: GRU encoder and decoder.

Port of ``mmvae_tpu/models/text.py``. The GRU is written out, as in the
JAX package: the input projections of all timesteps are ONE
``(B*T, E) @ (E, 3H)`` matmul before the recurrence, and only the
recurrent half runs in the per-step loop. The step keeps the n-gate bias
OUTSIDE ``r * (h @ u_n)``; ``torch.nn.GRU``/``GRUCell`` put ``b_hn``
inside, so they are not the same function and are not used.

The parameters keep the Flax layout: ``w_in`` ``(E, 3H)``, ``u_rec``
``(H, 3H)`` and ``b`` ``(3H,)``, gate order r, z, n. At a compute
``dtype`` other than float32 the embedding table, ``w_in``, ``u_rec`` and
``b`` are cast to it once, outside the loop over the steps, as the JAX
scan casts them (``mmvae_tpu/models/text.py:55-86``, ``:89-185``), the
recurrence runs in it, and the heads' logits and ``(mu, logvar)`` are cast
back to float32.

Token convention: ``PAD=0, START=1, STOP=2``, real symbols from 3. Targets
are stored padded with PAD after the STOP token.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mmvae_torch.core.rowrng import STREAM_TEXT, RowRng, categorical, temperature_terms
from mmvae_torch.models.experts import _layer

__all__ = ["PAD", "START", "STOP", "GRUExpert", "SeqEncoder", "SeqDecoder"]

PAD, START, STOP = 0, 1, 2


def _gates(u, b):
    """The recurrent weights and bias split into their r, z part and their
    n part, once, outside a loop over the steps."""
    hidden = u.shape[0]
    return u[:, : 2 * hidden], u[:, 2 * hidden :], b[: 2 * hidden], b[2 * hidden :]


def _gru_step(h, xw, gates):
    """One GRU step. ``xw`` is the precomputed input projection ``(B, 3H)``,
    ``gates`` the split recurrent weights of :func:`_gates`."""
    u_rz, u_n, b_rz, b_n = gates
    hidden = h.shape[-1]
    rz = torch.sigmoid(xw[..., : 2 * hidden] + h @ u_rz + b_rz)
    r, zg = rz[..., :hidden], rz[..., hidden:]
    n = torch.tanh(xw[..., 2 * hidden :] + r * (h @ u_n) + b_n)
    return (1.0 - zg) * n + zg * h


class GRUExpert(nn.Module):
    """The GRU weights an expert shares with its Flax twin:
    ``w_in`` (lecun-normal), ``u_rec`` (orthogonal) and ``b`` (zeros)."""

    def __init__(self, vocab_size: int, embed_dim: int, hidden: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.hidden = hidden
        self.dtype = dtype
        self.embed = nn.Embedding(vocab_size, embed_dim)
        self.w_in = nn.Parameter(torch.empty(embed_dim, 3 * hidden))
        self.u_rec = nn.Parameter(torch.empty(hidden, 3 * hidden))
        self.b = nn.Parameter(torch.zeros(3 * hidden))

    def _input_weights(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The embedding table and ``w_in`` at the compute dtype (Flax's
        ``Embed(dtype=)`` casts the table, then takes its rows)."""
        return self.embed.weight.to(self.dtype), self.w_in.to(self.dtype)

    def _input_proj(self, tokens: torch.Tensor, weights=None) -> torch.Tensor:
        """``(B, T)`` tokens -> ``(B, T, 3H)`` input projections, at the
        compute dtype (``weights``: :meth:`_input_weights`, where a loop
        has cast them once)."""
        table, w_in = weights or self._input_weights()
        return F.embedding(tokens.long(), table) @ w_in

    def _recurrent(self):
        """:func:`_gates` of the recurrent weights and bias cast to the
        compute dtype."""
        return _gates(self.u_rec.to(self.dtype), self.b.to(self.dtype))


class SeqEncoder(GRUExpert):
    """Token sequence -> ``(mu, logvar)`` via a GRU over embeddings."""

    def __init__(
        self, n_latents: int, vocab_size: int, embed_dim: int = 128, hidden: int = 256,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__(vocab_size, embed_dim, hidden, dtype)
        self.n_latents = n_latents
        self.head = nn.Linear(hidden, 2 * n_latents)

    def forward(self, tokens: torch.Tensor):
        xw = self._input_proj(tokens)  # (B, T, 3H)
        mask = (tokens != PAD).to(xw.dtype)[..., None]  # (B, T, 1)
        h = xw.new_zeros((tokens.shape[0], self.hidden))
        gates = self._recurrent()
        for t in range(tokens.shape[1]):
            h_new = _gru_step(h, xw[:, t], gates)
            h = mask[:, t] * h_new + (1.0 - mask[:, t]) * h
        out = _layer(self.head, h, self.dtype).float()
        return out[:, : self.n_latents], out[:, self.n_latents :]


class SeqDecoder(GRUExpert):
    """Latent -> autoregressive token logits (teacher-forced or generated)."""

    def __init__(
        self,
        n_latents: int,
        vocab_size: int,
        max_len: int,
        embed_dim: int = 128,
        hidden: int = 256,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__(vocab_size, embed_dim, hidden, dtype)
        self.max_len = max_len
        self.init_proj = nn.Linear(n_latents, hidden)
        self.out_proj = nn.Linear(hidden, vocab_size)

    def forward(self, z: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        """Teacher-forced logits ``(B, max_len, vocab)``.

        ``targets``: ``(B, max_len)`` int tokens (STOP-terminated,
        PAD-padded). The input at step t is START for t = 0, else
        ``targets[:, t - 1]``.
        """
        inputs = torch.cat(
            [torch.full_like(targets[:, :1], START), targets[:, :-1]], dim=1
        )
        xw = self._input_proj(inputs)  # (B, T, 3H)
        h = self._init_state(z)
        gates = self._recurrent()
        hs = []
        for t in range(inputs.shape[1]):
            h = _gru_step(h, xw[:, t], gates)
            hs.append(h)
        # One output-projection matmul for all timesteps.
        return _layer(self.out_proj, torch.stack(hs, dim=1), self.dtype).float()

    def _init_state(self, z: torch.Tensor) -> torch.Tensor:
        return torch.tanh(_layer(self.init_proj, z.to(self.dtype), self.dtype))

    def generate(
        self,
        z: torch.Tensor,
        temperature: float | torch.Tensor = 1.0,
        generator: torch.Generator | None = None,
        rng: RowRng | None = None,
    ) -> torch.Tensor:
        """Autoregressive decode: argmax when ``temperature <= 0``, else a
        draw at ``temperature`` from ``generator`` (on ``z``'s device).

        With ``rng`` the decode can be traced, in the JAX decoder's form
        (``mmvae_tpu/models/text.py:156-170``): ``temperature`` may be a
        0-d tensor, each step takes ``where(t > 0, sampled, greedy)``, and
        the sampled branch is the Gumbel-max draw on ``rng``'s per-row noise
        of stream ``STREAM_TEXT`` (``core/rowrng.py``), drawn for every
        step at once.

        Returns ``(B, max_len)`` int64 tokens with everything after the
        first STOP forced to PAD.
        """
        batch = z.shape[0]
        h = self._init_state(z)
        tok = torch.full((batch,), START, dtype=torch.long, device=z.device)
        stopped = torch.zeros((batch,), dtype=torch.bool, device=z.device)
        gates = self._recurrent()
        weights = self._input_weights()
        if rng is not None:
            terms = temperature_terms(torch.as_tensor(temperature, device=z.device))
            vocab = self.out_proj.out_features
            noise = rng.gumbel(STREAM_TEXT, self.max_len * vocab).reshape(
                -1, self.max_len, vocab)
        out = []
        for step in range(self.max_len):
            h = _gru_step(h, self._input_proj(tok, weights), gates)
            logits = _layer(self.out_proj, h, self.dtype).float()
            if rng is not None:
                nxt = categorical(logits, noise[:, step], terms)
            elif temperature > 0:
                probs = torch.softmax(logits / temperature, dim=-1)
                nxt = torch.multinomial(probs, 1, generator=generator)[:, 0]
            else:
                nxt = torch.argmax(logits, dim=-1)
            out.append(torch.where(stopped, PAD, nxt))
            stopped = stopped | (nxt == STOP)
            tok = nxt
        return torch.stack(out, dim=1)
