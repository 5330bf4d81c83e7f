"""LSTM language models of the federated text benchmarks.

The counterparts of ``fedml_tpu/models/rnn.py`` (reference
fedml_api/model/nlp/rnn.py):

- :class:`RNN_OriginalFedAvg` (:5), the McMahan et al. Shakespeare char
  LM: embedding(8) -> 2x LSTM(256) -> dense(vocab); the last step's
  logits, or every step's with ``seq_output=True`` (``rnn_seq``, the
  per-token layout of the shakespeare loaders);
- :class:`RNN_StackOverflow` (:41), the "Adaptive Federated Optimization"
  next-word model: embedding(96) over the extended vocab (10,000 words +
  pad, bos, eos and one oov bucket) -> LSTM(670) -> dense(96) ->
  dense(10,004), every step scored. 4,050,748 parameters.

The LSTM is the explicit cell of ``models/common.LSTM`` (flax's
``OptimizedLSTMCell`` with a zero carry each batch), not ``torch.nn.LSTM``:
cuDNN's LSTM keeps two biases and packs its own weight layout, which sits
badly with ``functional_call`` over a state dict and with CUDA-graph
capture.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from fedml_tpu_torch.models.common import LSTM


class RNN_OriginalFedAvg(nn.Module):
    flax_names = {"embed": "Embed_0", "lstm1": "OptimizedLSTMCell_0",
                  "lstm2": "OptimizedLSTMCell_1", "fc": "Dense_0"}

    def __init__(self, vocab_size: int = 90, embedding_dim: int = 8,
                 hidden_size: int = 256, seq_output: bool = False):
        super().__init__()
        self.seq_output = seq_output
        self.embed = nn.Embedding(vocab_size, embedding_dim)
        self.lstm1 = LSTM(embedding_dim, hidden_size)
        self.lstm2 = LSTM(hidden_size, hidden_size)
        self.fc = nn.Linear(hidden_size, vocab_size)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = self.lstm2(self.lstm1(self.embed(x.long())))
        if not self.seq_output:
            h = h[:, -1]
        return self.fc(h)


class RNN_StackOverflow(nn.Module):
    def __init__(self, vocab_size: int = 10000, num_oov_buckets: int = 1,
                 embedding_size: int = 96, latent_size: int = 670,
                 num_layers: int = 1):
        super().__init__()
        extended = vocab_size + 3 + num_oov_buckets
        self.embed = nn.Embedding(extended, embedding_size)
        self.lstms = nn.ModuleList(
            LSTM(embedding_size if i == 0 else latent_size, latent_size)
            for i in range(num_layers))
        self.fc1 = nn.Linear(latent_size, embedding_size)
        self.fc2 = nn.Linear(embedding_size, extended)
        self.flax_names = {"embed": "Embed_0", "fc1": "Dense_0",
                           "fc2": "Dense_1"}
        for i in range(num_layers):
            self.flax_names[f"lstms.{i}"] = f"OptimizedLSTMCell_{i}"

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = self.embed(x.long())
        for lstm in self.lstms:
            h = lstm(h)
        return self.fc2(self.fc1(h))  # [B, T, extended vocab]
