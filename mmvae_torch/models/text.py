"""Sequence (text / digit-string) experts: GRU encoder and decoder.

Port of ``mmvae_tpu/models/text.py``. The GRU is written out, as in the
JAX package: the input projections of all timesteps are ONE
``(B*T, E) @ (E, 3H)`` matmul before the recurrence, and only the
recurrent half runs in the per-step loop. The step keeps the n-gate bias
OUTSIDE ``r * (h @ u_n)``; ``torch.nn.GRU``/``GRUCell`` put ``b_hn``
inside, so they are not the same function and are not used.

The parameters keep the Flax layout: ``w_in`` ``(E, 3H)``, ``u_rec``
``(H, 3H)`` and ``b`` ``(3H,)``, gate order r, z, n.

Token convention: ``PAD=0, START=1, STOP=2``, real symbols from 3. Targets
are stored padded with PAD after the STOP token.
"""

from __future__ import annotations

import torch
from torch import nn

__all__ = ["PAD", "START", "STOP", "GRUExpert", "SeqEncoder", "SeqDecoder"]

PAD, START, STOP = 0, 1, 2


def _gru_step(h, xw, u, b):
    """One GRU step. ``xw`` is the precomputed input projection ``(B, 3H)``."""
    hidden = h.shape[-1]
    gates = xw[..., : 2 * hidden] + h @ u[:, : 2 * hidden] + b[: 2 * hidden]
    r = torch.sigmoid(gates[..., :hidden])
    zg = torch.sigmoid(gates[..., hidden : 2 * hidden])
    n = torch.tanh(
        xw[..., 2 * hidden :] + r * (h @ u[:, 2 * hidden :]) + b[2 * hidden :]
    )
    return (1.0 - zg) * n + zg * h


class GRUExpert(nn.Module):
    """The GRU weights an expert shares with its Flax twin:
    ``w_in`` (lecun-normal), ``u_rec`` (orthogonal) and ``b`` (zeros)."""

    def __init__(self, vocab_size: int, embed_dim: int, hidden: int):
        super().__init__()
        self.hidden = hidden
        self.embed = nn.Embedding(vocab_size, embed_dim)
        self.w_in = nn.Parameter(torch.empty(embed_dim, 3 * hidden))
        self.u_rec = nn.Parameter(torch.empty(hidden, 3 * hidden))
        self.b = nn.Parameter(torch.zeros(3 * hidden))

    def _input_proj(self, tokens: torch.Tensor) -> torch.Tensor:
        """``(B, T)`` tokens -> ``(B, T, 3H)`` input projections."""
        return self.embed(tokens.long()) @ self.w_in


class SeqEncoder(GRUExpert):
    """Token sequence -> ``(mu, logvar)`` via a GRU over embeddings."""

    def __init__(
        self, n_latents: int, vocab_size: int, embed_dim: int = 128, hidden: int = 256
    ):
        super().__init__(vocab_size, embed_dim, hidden)
        self.n_latents = n_latents
        self.head = nn.Linear(hidden, 2 * n_latents)

    def forward(self, tokens: torch.Tensor):
        xw = self._input_proj(tokens)  # (B, T, 3H)
        mask = (tokens != PAD).to(xw.dtype)[..., None]  # (B, T, 1)
        h = xw.new_zeros((tokens.shape[0], self.hidden))
        for t in range(tokens.shape[1]):
            h_new = _gru_step(h, xw[:, t], self.u_rec, self.b)
            h = mask[:, t] * h_new + (1.0 - mask[:, t]) * h
        out = self.head(h)
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
    ):
        super().__init__(vocab_size, embed_dim, hidden)
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
        h = torch.tanh(self.init_proj(z))
        hs = []
        for t in range(inputs.shape[1]):
            h = _gru_step(h, xw[:, t], self.u_rec, self.b)
            hs.append(h)
        # One output-projection matmul for all timesteps.
        return self.out_proj(torch.stack(hs, dim=1))

    def generate(
        self,
        z: torch.Tensor,
        temperature: float = 1.0,
        generator: torch.Generator | None = None,
    ) -> torch.Tensor:
        """Autoregressive decode: argmax when ``temperature <= 0``, else a
        draw at ``temperature`` from ``generator`` (on ``z``'s device).

        Returns ``(B, max_len)`` int64 tokens with everything after the
        first STOP forced to PAD.
        """
        batch = z.shape[0]
        h = torch.tanh(self.init_proj(z))
        tok = torch.full((batch,), START, dtype=torch.long, device=z.device)
        stopped = torch.zeros((batch,), dtype=torch.bool, device=z.device)
        out = []
        for _ in range(self.max_len):
            h = _gru_step(h, self._input_proj(tok), self.u_rec, self.b)
            logits = self.out_proj(h)
            if temperature > 0:
                probs = torch.softmax(logits / temperature, dim=-1)
                nxt = torch.multinomial(probs, 1, generator=generator)[:, 0]
            else:
                nxt = torch.argmax(logits, dim=-1)
            out.append(torch.where(stopped, PAD, nxt))
            stopped = stopped | (nxt == STOP)
            tok = nxt
        return torch.stack(out, dim=1)
