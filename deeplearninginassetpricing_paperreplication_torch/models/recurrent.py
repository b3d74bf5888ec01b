"""The macro LSTM as an explicit cell loop, with PyTorch's LSTM semantics.

The counterpart of the JAX package's ``models/recurrent.py``: gate order
i, f, g, o; the input projection of every step hoisted into one product,
``x @ W_ihᵀ + (b_ih + b_hh)``; and the split between a full-sequence scan
that returns the final (h, c) carry and an O(1) step that continues it —
the split the serving engine's incremental macro state rides on.

The parameters live in an ``nn.LSTM`` named ``lstm`` so that the
reference's ``sdf_net.macro_lstm.lstm.*`` keys load as they are; its cuDNN
forward is not used. Every function also takes parameters with a leading
member axis (``w_ih [S, 4H, I]``), which the ensemble paths use to run all
members' recurrences together.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch
from torch import nn

Carry = Tuple[torch.Tensor, torch.Tensor]
LayerParams = Dict[str, torch.Tensor]
# one generator, or one per member (leading axis) of a member-stacked tensor
Generators = Union[torch.Generator, Sequence[torch.Generator], None]


def _mT(w: torch.Tensor) -> torch.Tensor:
    return w.transpose(-1, -2)


def _rowmat(v: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """v [..., H] @ w[..., H, K] → [..., K], broadcasting a member axis."""
    return (v.unsqueeze(-2) @ w).squeeze(-2)


def _gates(z: torch.Tensor, c: torch.Tensor) -> Carry:
    i, f, g, o = z.chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new, c_new


def lstm_project(p: LayerParams, x: torch.Tensor) -> torch.Tensor:
    """The hoisted input projection of every step: x [..., T, I] →
    ``x @ W_ihᵀ + (b_ih + b_hh)`` [..., T, 4H]."""
    return x @ _mT(p["w_ih"]) + (p["b_ih"] + p["b_hh"]).unsqueeze(-2)


def lstm_scan(p: LayerParams, x: torch.Tensor,
              carry: Optional[Carry] = None) -> Tuple[torch.Tensor, Carry]:
    """One layer over a sequence: x [..., T, I] → (h sequence [..., T, H],
    final carry (h [..., H], c [..., H]))."""
    return lstm_recur(p, lstm_project(p, x), carry)


def lstm_recur(p: LayerParams, zx: torch.Tensor,
               carry: Optional[Carry] = None) -> Tuple[torch.Tensor, Carry]:
    """:func:`lstm_scan`'s recurrence over a projected sequence zx
    [..., T, 4H] (:func:`lstm_project`) from `carry` (zeros without one)."""
    H = p["w_hh"].shape[-1]
    w_hh_t = _mT(p["w_hh"])
    if carry is None:
        zeros = zx.new_zeros(zx.shape[:-2] + (H,))
        carry = (zeros, zeros)
    h, c = carry
    ys = []
    for t in range(zx.shape[-2]):
        h, c = _gates(zx[..., t, :] + _rowmat(h, w_hh_t), c)
        ys.append(h)
    return torch.stack(ys, dim=-2), (h, c)


def lstm_step(p: LayerParams, carry: Carry, x_t: torch.Tensor) -> Carry:
    """One O(1) step continuing :func:`lstm_scan`'s carry (same hoisted-bias
    formulation as the scan body)."""
    zx_t = _rowmat(x_t, _mT(p["w_ih"])) + (p["b_ih"] + p["b_hh"])
    return _gates(zx_t + _rowmat(carry[0], _mT(p["w_hh"])), carry[1])


def _rand(shape, generator: torch.Generator, device,
          span: Optional[Tuple[int, int, int, int]]) -> torch.Tensor:
    """U[0, 1) of `shape`; with `span` (dim, start, stop, n) drawn at n
    along dim and cut to [start, stop): a stock shard's part of the
    unsharded draw."""
    if span is None:
        return torch.rand(shape, generator=generator, device=device)
    dim, start, stop, n = span
    full = list(shape)
    full[dim] = n
    u = torch.rand(full, generator=generator, device=device)
    return u.narrow(dim, start, stop - start)


def dropout(x: torch.Tensor, rate: float, generator: Generators,
            span: Optional[Tuple[int, int, int, int]] = None
            ) -> torch.Tensor:
    """Inverted dropout drawn from an explicit generator; the identity
    without one (eval) or at rate 0. With one generator per member, member
    s's slice x[s] draws from its own, exactly as a one-member call with
    that generator draws (only the draw is per member). `span` (dim,
    start, stop, n), dim counted from the end: x holds the part [start,
    stop) of an axis of n, and draws that part of the draw at n."""
    if generator is None or rate <= 0.0:
        return x
    if isinstance(generator, torch.Generator):
        u = _rand(x.shape, generator, x.device, span)
    else:
        u = torch.stack([_rand(x.shape[1:], g, x.device, span)
                         for g in generator])
    keep = u >= rate
    return x * keep.to(x.dtype) / (1.0 - rate)


def stacked_lstm_scan(layers: Sequence[LayerParams], x: torch.Tensor,
                      dropout_rate: float = 0.0,
                      generator: Generators = None
                      ) -> Tuple[torch.Tensor, List[Carry]]:
    """x [..., T, M] → (last layer's h sequence [..., T, H], per-layer
    final carries). Between layers (only when there are several), training
    draws dropout from `generator`; without one, dropout is the identity."""
    carries = []
    for li, p in enumerate(layers):
        x, carry = lstm_scan(p, x)
        carries.append(carry)
        if li < len(layers) - 1:
            x = dropout(x, dropout_rate, generator)
    return x, carries


def stacked_lstm_step(layers: Sequence[LayerParams], carries: Sequence[Carry],
                      x_t: torch.Tensor) -> Tuple[torch.Tensor, List[Carry]]:
    """One incremental month through every layer: (new last-layer h, new
    per-layer carries)."""
    new = []
    for p, carry in zip(layers, carries):
        carry = lstm_step(p, carry, x_t)
        x_t = carry[0]
        new.append(carry)
    return x_t, new


def layer_params(params: Dict[str, torch.Tensor], num_layers: int,
                 prefix: str = "") -> List[LayerParams]:
    """Per-layer dicts from torch-named parameters (``{prefix}weight_ih_l0``
    …), with or without a leading member axis."""
    return [{"w_ih": params[f"{prefix}weight_ih_l{li}"],
             "w_hh": params[f"{prefix}weight_hh_l{li}"],
             "b_ih": params[f"{prefix}bias_ih_l{li}"],
             "b_hh": params[f"{prefix}bias_hh_l{li}"]}
            for li in range(num_layers)]


class MacroLSTM(nn.Module):
    """Stacked LSTM over a [T, M] macro series → [T, H] (the reference's
    wrapper module; its parameters are ``lstm.*``)."""

    def __init__(self, input_dim: int, hidden_sizes: Sequence[int],
                 dropout: float = 0.0):
        super().__init__()
        hidden_sizes = tuple(hidden_sizes)
        if len(set(hidden_sizes)) != 1:
            raise ValueError("torch.nn.LSTM has one hidden size for every "
                             f"layer; got num_units_rnn={list(hidden_sizes)}")
        self.num_layers = len(hidden_sizes)
        self.lstm = nn.LSTM(input_dim, hidden_sizes[-1],
                            num_layers=self.num_layers, batch_first=True,
                            dropout=dropout if self.num_layers > 1 else 0.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        layers = layer_params(dict(self.lstm.named_parameters()),
                              self.num_layers)
        return stacked_lstm_scan(layers, x)[0]
