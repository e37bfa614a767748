"""LSTM text classifier (counterpart of ``elephas_tpu/models/lstm.py``;
BASELINE config 3: the IMDB LSTM trained through the estimator).

Embedding, one LSTM layer over the whole pre-padded sequence from a zero
carry, the last step's output, optional dropout, then the logits. Token
ids may arrive as floats (a DataFrame column); the model casts them, as
the flax model casts to int32.

The parameters are flax ``OptimizedLSTMCell``'s leaves one for one: four
input kernels without bias (``cell.ii``, ``cell.if``, ``cell.ig``,
``cell.io``) and four hidden kernels with a bias each (``cell.hi``, ...,
``cell.ho``), each an ``nn.Linear`` holding its (out, in) weight. They
are never packed into shared storage: ``nn.LSTM``'s two biases would
take two gradient steps where flax takes one, and its packed weights
would change ``lamb``'s per-tensor trust ratio, hogwild's leaf units and
the parameter-server frames. Each forward concatenates them into cuDNN's
(i, f, g, o) layout, with a zero input-side bias, and runs an
``nn.LSTM`` template through ``torch.func.functional_call``, so the
gradients flow back to each leaf.
"""

from __future__ import annotations

import warnings

import torch
import torch.nn as nn
from torch.func import functional_call

from elephas_tpu_torch.models import register_model
from elephas_tpu_torch.models.mlp import dropout
from elephas_tpu_torch.utils.device import resolve_device

GATES = ("i", "f", "g", "o")  # cuDNN's and flax's gate order

# cuDNN warns on every call whose weights do not share one flat buffer.
# Here they never do, by design (see above): the concatenated copies are
# made each forward, so the warning says nothing about this model.
warnings.filterwarnings("ignore", message="RNN module weights are not part of single "
                        "contiguous chunk of memory", category=UserWarning)


class LSTMClassifier(nn.Module):
    """Token ids (batch, seq) in, logits (batch, num_classes) out.
    ``dropout_generator`` (a ``torch.Generator`` on the module's device,
    or None for torch's default one) draws the dropout masks."""

    def __init__(self, vocab_size=20000, embed_dim=128, hidden_dim=128, num_classes=2,
                 dropout_rate=0.0, device=None):
        super().__init__()
        self.embed = nn.Embedding(vocab_size, embed_dim, device=device)
        self.cell = nn.ModuleDict()
        for g in GATES:
            self.cell[f"i{g}"] = nn.Linear(embed_dim, hidden_dim, bias=False, device=device)
        for g in GATES:
            self.cell[f"h{g}"] = nn.Linear(hidden_dim, hidden_dim, device=device)
        self.out = nn.Linear(hidden_dim, num_classes, device=device)
        self.dropout_rate = dropout_rate
        self.dropout_generator = None
        # Held outside the module tree (a tuple): it only names cuDNN's
        # call, its own parameters are replaced in every forward.
        self._template = (nn.LSTM(embed_dim, hidden_dim, batch_first=True, device="meta"),)

    def forward(self, tokens, train: bool = False):
        x = self.embed(tokens.long())
        cell = self.cell
        weights = {
            "weight_ih_l0": torch.cat([cell[f"i{g}"].weight for g in GATES]),
            "weight_hh_l0": torch.cat([cell[f"h{g}"].weight for g in GATES]),
            "bias_ih_l0": x.new_zeros(4 * cell["hi"].out_features),
            "bias_hh_l0": torch.cat([cell[f"h{g}"].bias for g in GATES]),
        }
        x, _ = functional_call(self._template[0], weights, (x,))
        x = dropout(x[:, -1], self.dropout_rate, self.training, self.dropout_generator)
        return self.out(x)


@register_model("lstm")
def build_lstm(vocab_size=20000, embed_dim=128, hidden_dim=128, num_classes=2,
               dropout_rate=0.0, device=None):
    return LSTMClassifier(vocab_size=vocab_size, embed_dim=embed_dim, hidden_dim=hidden_dim,
                          num_classes=num_classes, dropout_rate=dropout_rate,
                          device=resolve_device(device))
