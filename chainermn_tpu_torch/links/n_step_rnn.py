"""Multi-node N-step RNN.

Port of ``chainermn_tpu/links/n_step_rnn.py`` (``LSTMStack`` :27,
``MultiNodeNStepRNN`` :84, ``create_multi_node_n_step_rnn`` :103;
ChainerMN's ``create_multi_node_n_step_rnn(link, comm, rank_in,
rank_out)``): the LSTM stack whose final ``(h, c)`` streams to the next
rank in the model-parallel seq2seq.

The JAX cell is ``xproj = Dense(x)`` (kernel and bias) plus ``h @ wh``
(no bias), gates in the order i, f, g, o.  Those are exactly the
trainable parameters here: per layer ``wx_{l}`` (an ``nn.Linear``) and
``wh_{l}`` (``(4H, H)``, ``nn.LSTM``'s ``weight_hh`` layout).  The
recurrence is one ``torch.lstm`` call over the whole stack and sequence,
with a constant zero as its second bias: cuDNN's LSTM on a card, ATen's
on the CPU, the same function (``torch.nn.LSTM`` would train a second
bias that the reference does not have).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn


def _lecun_normal_(w: torch.Tensor, g: torch.Generator) -> None:
    """flax's lecun_normal: truncated normal (2 sigma), variance
    1 / fan_in (``w``'s second axis here)."""
    std = (1.0 / w.shape[1]) ** 0.5 / 0.87962566103423978
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=g)


class LSTMStack(nn.Module):
    """Multi-layer LSTM over a whole sequence (batch first).

    ``forward(xs, init_state=None)``: ``xs`` is ``(batch, time,
    input_size)``, ``init_state`` an ``(h, c)`` pair of ``(num_layers,
    batch, hidden_size)`` (zeros if None).  Returns ``((h, c), outputs)``
    with the final states stacked over layers and ``outputs`` of
    ``(batch, time, hidden_size)``."""

    def __init__(self, input_size: int, hidden_size: int,
                 num_layers: int = 1, *, seed: int = 0):
        super().__init__()
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        g = torch.Generator().manual_seed(seed)
        for layer in range(num_layers):
            wx = nn.Linear(input_size if layer == 0 else hidden_size,
                           4 * hidden_size)
            wh = nn.Parameter(torch.empty(4 * hidden_size, hidden_size))
            with torch.no_grad():
                _lecun_normal_(wx.weight, g)
                wx.bias.zero_()
                _lecun_normal_(wh, g)
            setattr(self, f"wx_{layer}", wx)
            setattr(self, f"wh_{layer}", wh)
        self.register_buffer("zero_bias", torch.zeros(4 * hidden_size),
                             persistent=False)

    def flat_weights(self) -> list:
        """``torch.lstm``'s parameter list: per layer the input weight,
        the recurrent weight, the input bias and the constant zero."""
        out = []
        for layer in range(self.num_layers):
            wx = getattr(self, f"wx_{layer}")
            out += [wx.weight, getattr(self, f"wh_{layer}"), wx.bias,
                    self.zero_bias]
        return out

    def forward(self, xs: torch.Tensor, init_state=None):
        if init_state is None:
            zeros = xs.new_zeros(self.num_layers, xs.shape[0],
                                 self.hidden_size)
            init_state = (zeros, zeros)
        h0, c0 = init_state
        ys, h, c = torch.lstm(xs, (h0, c0), self.flat_weights(), True,
                              self.num_layers, 0.0, self.training, False,
                              True)
        return (h, c), ys


class MultiNodeNStepRNN(LSTMStack):
    """The LSTM stack packaged for pipeline placement:
    ``forward(xs, incoming_state=None)`` takes a neighbour's final state
    (None for the first stage) and returns ``(state, outputs)``, the
    state being what streams to ``rank_out``."""

    def forward(self, xs: torch.Tensor, incoming_state=None):
        return super().forward(xs, incoming_state)


def create_multi_node_n_step_rnn(input_size: int, hidden_size: int,
                                 num_layers: int = 1, comm=None,
                                 rank_in: Optional[int] = None,
                                 rank_out: Optional[int] = None,
                                 *, seed: int = 0):
    """The reference's factory (``create_multi_node_n_step_rnn(link,
    comm, rank_in, rank_out)``).  With ``rank_in`` or ``rank_out`` it
    returns a :class:`~chainermn_tpu_torch.link.PlacedModule` carrying
    that routing, which ``MultiNodeChainList.add_link(placed)`` applies;
    with neither, the bare module.  ``comm`` is kept for parity."""
    del comm
    rnn = MultiNodeNStepRNN(input_size, hidden_size, num_layers, seed=seed)
    if rank_in is None and rank_out is None:
        return rnn
    from ..link import PlacedModule

    return PlacedModule(rnn, rank_in=rank_in, rank_out=rank_out)
