"""Word-level vocabulary for caption modalities (port of ``mmvae_tpu/data/vocab.py``).

Token convention shared with ``mmvae_torch.models.text``: PAD=0, START=1,
STOP=2, words from 3.
"""

from __future__ import annotations

import numpy as np

from mmvae_torch.models.text import PAD, START, STOP

__all__ = ["Vocab"]


class Vocab:
    """Bidirectional word <-> id map with encode/decode to fixed length."""

    RESERVED = ("<pad>", "<start>", "<stop>")
    UNK = "<unk>"

    def __init__(self, words: list[str], unk: bool = False):
        extra = (self.UNK,) if unk else ()
        self.itos = list(self.RESERVED) + list(extra) + list(dict.fromkeys(words))
        self.stoi = {w: i for i, w in enumerate(self.itos)}

    def __len__(self) -> int:
        return len(self.itos)

    def encode(self, sentence: str, max_len: int) -> np.ndarray:
        """Tokenize, append STOP, PAD-pad/truncate to ``max_len``.

        Out-of-vocabulary words map to ``<unk>`` when the vocab was built
        with ``unk=True``; otherwise they raise (the closed synthetic
        vocabulary)."""
        unk_id = self.stoi.get(self.UNK)
        words = sentence.split()[: max_len - 1]
        if unk_id is None:
            ids = [self.stoi[w] for w in words]
        else:
            ids = [self.stoi.get(w, unk_id) for w in words]
        ids.append(STOP)
        ids += [PAD] * (max_len - len(ids))
        return np.asarray(ids, dtype=np.int32)

    def decode(self, ids) -> str:
        words = []
        for i in np.asarray(ids).tolist():
            if i == STOP or i == PAD:
                break
            if i != START:
                words.append(self.itos[i])
        return " ".join(words)
