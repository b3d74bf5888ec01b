"""SDF (generator) and Moment (discriminator) networks as ``nn.Module``s.

The counterparts of the JAX package's ``models/networks.py``, with the
reference's module names (``sdf_net.macro_lstm.lstm``, ``fc_layers.{3i}``,
``output_proj``), so reference ``.pt`` checkpoints load strictly:

* :class:`SDFNet`: macro LSTM → concat ``[individual, macro_state]`` → FFN
  (ReLU, dropout) → Linear(1) → mask → cross-sectional zero-mean.
* :class:`MomentNet`: concat ``[macro, individual]`` → (optional FFN) →
  Linear(K) → tanh → [K, T, N].
* :class:`SimpleSDF`: the non-adversarial baseline, concat ``[macro,
  individual]`` → FFN → Linear(1) → mask → zero-mean, with
  :func:`simple_sdf_forward` its unweighted unconditional loss.

Both first layers are applied concat-free: the weight splits into a
per-stock block and a per-period block, ``concat([stock, period]) @ Wᵀ ==
stock @ W_sᵀ + period @ W_pᵀ``, so the [T, N, F + D] concat never exists.

The SDF FFN itself runs member-stacked through :mod:`..ops.sdf_ffn`: on a
CUDA device in the hand-written kernels, on the CPU in their plain
versions. The functional core (:func:`sdf_raw_weights`) takes parameters
with a leading member axis; one module is the S = 1 case of it.

Training mode is chosen per call, as in the JAX package (an ``rng``
there): a dropout ``seed`` for the FFN (whose kernels draw the masks from
it) and a ``torch.Generator`` for the LSTM's inter-layer and the moment
net's dropout. Without them every dropout is the identity. Member-stacked
training gives one seed and one generator per member, so member s draws
the masks of a one-model run with its own seed.

Ensemble training works on member-stacked parameter dicts (the reference's
``state_dict`` keys, each tensor [S, ...]): :func:`init_member_params`
draws them, :func:`moment_output_members` and :func:`moment_h_members` are
the moment net over them.

Under a stock shard (``parallel.collectives.StockShard``) the panel holds
the rank's stocks only: the cross-sectional zero-mean sums and counts over
every rank's stocks, the FFN hashes its dropout on the global stock index
(its ``offset``), and a moment net with hidden layers draws its dropout at
the global stock count and keeps its span, so a rank's masks are the
unsharded run's over its span. The LSTM sees only the replicated macro
series and is unchanged.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch
from torch import nn

from ..ops import sdf_ffn
from ..ops.losses import unconditional_loss
from ..parallel.collectives import StockShard, is_sharded, stock_sum
from ..ops.metrics import sharpe_monitor
from ..utils.config import ExecutionConfig, GANConfig
from .recurrent import (
    Generators,
    MacroLSTM,
    dropout,
    layer_params,
    stacked_lstm_scan,
)

_DEFAULT_EXEC = ExecutionConfig()


def masked_zero_mean(weights: torch.Tensor, mask: torch.Tensor,
                     shard: Optional[StockShard] = None) -> torch.Tensor:
    """Cross-sectional zero-mean per period over valid stocks (last axis;
    under a stock shard, over every rank's stocks)."""
    count = stock_sum(mask, -1, shard, keepdim=True).clamp_min(1)
    mean = stock_sum(weights * mask, -1, shard, keepdim=True) / count
    return (weights - mean) * mask


def _fc_stack(d_in: int, hidden: Sequence[int], dropout: float) -> nn.Sequential:
    """(Linear, ReLU, Dropout) triplets: the Linear of layer i sits at 3·i."""
    layers: List[nn.Module] = []
    for h in hidden:
        layers += [nn.Linear(d_in, h), nn.ReLU(), nn.Dropout(dropout)]
        d_in = h
    return nn.Sequential(*layers)


def init_params(module: nn.Module, generator: torch.Generator) -> None:
    """Re-draw every parameter from ``generator`` with torch's default
    bounds: U(±1/√fan_in) for a Linear's weight and bias, U(±1/√H) for an
    LSTM's."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.Linear):
                k = m.in_features ** -0.5
            elif isinstance(m, nn.LSTM):
                k = m.hidden_size ** -0.5
            else:
                continue
            for p in m.parameters(recurse=False):
                p.copy_(torch.rand(p.shape, generator=generator) * 2 * k - k)


# -- the SDF network's functional core -------------------------------------


def init_member_params(cfg: GANConfig, seeds: Sequence[int]
                       ) -> Dict[str, torch.Tensor]:
    """Member-stacked initial parameters [S, ...] (CPU, float32): member s
    is what ``train_3phase(seed=seeds[s])`` starts from (``init_params``
    with ``torch.Generator().manual_seed(seeds[s])``)."""
    sds = []
    for seed in seeds:
        module = AssetPricingModule(cfg)
        init_params(module, torch.Generator().manual_seed(int(seed)))
        sds.append(module.state_dict())
    return {k: torch.stack([sd[k].float() for sd in sds]) for k in sds[0]}


def macro_states(params: Mapping[str, torch.Tensor], cfg: GANConfig,
                 macro: Optional[torch.Tensor],
                 generator: Generators = None) -> Optional[torch.Tensor]:
    """[S, T, Dp] per-member macro state from ``sdf_net``-relative,
    member-stacked params: the LSTM's h sequence, the raw macro when the
    config runs no LSTM, None without macro. `generator` (one, or one per
    member) draws the LSTM's inter-layer dropout (training)."""
    if macro is None or cfg.macro_feature_dim == 0:
        return None
    S = params["output_proj.bias"].shape[0]
    if not cfg.use_rnn:
        return macro.expand(S, *macro.shape)
    layers = layer_params(params, len(cfg.num_units_rnn), "macro_lstm.lstm.")
    hs, _ = stacked_lstm_scan(layers, macro, cfg.dropout, generator)
    return hs


def ffn_pieces(params: Mapping[str, torch.Tensor], cfg: GANConfig,
               macro_state: Optional[torch.Tensor], T: int):
    """(zp [S, T, H1], k1T [S, H1, F], mids, kout [S, HL], bout [S]) — the
    kernel's parameter inputs, from member-stacked ``sdf_net`` params.

    The first layer's weight [H1, F + Dp] splits in the reference's concat
    order ``[individual, macro_state]``: ``k1T = W[:, :F]`` and the
    per-period bias ``zp = macro_state @ W[:, F:]ᵀ + b``."""
    F = cfg.individual_feature_dim
    w0, b0 = params["fc_layers.0.weight"], params["fc_layers.0.bias"]
    k1T = w0[:, :, :F]
    if macro_state is not None:
        zp = macro_state @ w0[:, :, F:].transpose(1, 2) + b0[:, None, :]
    else:
        zp = b0[:, None, :].expand(b0.shape[0], T, b0.shape[1])
    mids = [(params[f"fc_layers.{3 * i}.weight"],
             params[f"fc_layers.{3 * i}.bias"])
            for i in range(1, len(cfg.hidden_dim))]
    kout = params["output_proj.weight"][:, 0, :]
    bout = params["output_proj.bias"][:, 0]
    return zp.contiguous(), k1T, mids, kout, bout


def pack_sdf_ffn(params: Mapping[str, torch.Tensor], cfg: GANConfig,
                 compute_dtype: str) -> sdf_ffn.PackedFfn:
    """The member-stacked FFN weights packed once in the kernel's layout
    (the serving engine keeps this across requests)."""
    _, k1T, mids, kout, bout = ffn_pieces(params, cfg, None, 1)
    return sdf_ffn.pack_ffn(k1T, mids, kout, bout, compute_dtype)


def sdf_raw_weights(params: Mapping[str, torch.Tensor], cfg: GANConfig,
                    exec_cfg: ExecutionConfig, x_t: torch.Tensor,
                    macro_state: Optional[torch.Tensor],
                    packed: Optional[sdf_ffn.PackedFfn] = None,
                    seed: Optional[sdf_ffn.Seed] = None,
                    offset: int = 0) -> torch.Tensor:
    """Unmasked weights [S, T, N] of S members on the feature-major panel
    x_t [T, F, N], given each member's macro state [S, T, Dp] (or None).
    With hidden layers this is ONE fused-FFN call over all members: from
    weights packed once (`packed`, the serving path), or differentiable,
    with dropout drawn from `seed` (one int, or one per member) when one is
    given (training), hashed on the global stock index from `offset`."""
    T = x_t.shape[0]
    if not cfg.hidden_dim:
        # no hidden layer: the output projection is the split layer itself,
        # on an f32 panel (ExecutionConfig.stores_bf16_panel needs hidden
        # layers, so prepare_batch never gives this path a bf16 one)
        if x_t.dtype != torch.float32:
            raise ValueError("an SDF net without hidden layers reads an f32 "
                             f"panel; got {x_t.dtype}")
        F = cfg.individual_feature_dim
        w = params["output_proj.weight"][:, 0, :]  # [S, F + Dp]
        out = torch.einsum("sf,tfn->stn", w[:, :F], x_t)
        out = out + params["output_proj.bias"][:, :, None]  # [S, 1, 1]
        if macro_state is not None:
            out = out + (macro_state @ w[:, F:, None])  # [S, T, 1]
        return out
    zp, k1T, mids, kout, bout = ffn_pieces(params, cfg, macro_state, T)
    if packed is not None:
        return sdf_ffn.sdf_ffn_packed(x_t, zp, packed, kernel=exec_cfg.kernel)
    training = seed is not None and cfg.dropout > 0.0
    return sdf_ffn.sdf_ffn(
        x_t, zp, k1T, mids, kout, bout, seed=seed if training else 0,
        dropout_rate=cfg.dropout if training else 0.0,
        compute_dtype=exec_cfg.compute_dtype, kernel=exec_cfg.kernel,
        offset=offset)


class SDFNet(nn.Module):
    """Generator: per-stock portfolio weights [T, N] from the panel."""

    def __init__(self, cfg: GANConfig, exec_cfg: Optional[ExecutionConfig] = None):
        super().__init__()
        self.cfg = cfg
        self.exec_cfg = exec_cfg or _DEFAULT_EXEC
        if cfg.use_rnn and cfg.macro_feature_dim > 0:
            self.macro_lstm = MacroLSTM(cfg.macro_feature_dim,
                                        cfg.num_units_rnn, cfg.dropout)
        self.fc_layers = _fc_stack(cfg.sdf_input_dim, cfg.hidden_dim,
                                   cfg.dropout)
        d_last = cfg.hidden_dim[-1] if cfg.hidden_dim else cfg.sdf_input_dim
        self.output_proj = nn.Linear(d_last, 1)

    def forward(self, macro: Optional[torch.Tensor], individual: torch.Tensor,
                mask: torch.Tensor, individual_t: Optional[torch.Tensor] = None,
                macro_state: Optional[torch.Tensor] = None,
                seed: Optional[int] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Weights [T, N]. ``macro_state`` [T, Dp] bypasses the LSTM with a
        caller-carried state (then ``macro`` is not read). Training mode:
        `seed` draws the FFN's dropout, `generator` the LSTM's; without
        them the forward is the eval forward."""
        params = {n: p[None] for n, p in self.named_parameters()}
        if macro_state is None:
            macro_state = macro_states(params, self.cfg, macro, generator)
        else:
            macro_state = macro_state[None]
        if individual_t is None:
            individual_t = individual.permute(0, 2, 1).contiguous()
        shard = self.exec_cfg.shard
        w = sdf_raw_weights(params, self.cfg, self.exec_cfg, individual_t,
                            macro_state, seed=seed,
                            offset=shard.start if shard else 0)[0]
        w = w * mask
        if self.cfg.normalize_w:
            w = masked_zero_mean(w, mask, shard)
        return w


class MomentNet(nn.Module):
    """Discriminator: K bounded moment functions h_k(t, i) in [-1, 1],
    from the RAW macro and the characteristics, concat order
    ``[macro, individual]``."""

    def __init__(self, cfg: GANConfig, exec_cfg: Optional[ExecutionConfig] = None):
        super().__init__()
        self.cfg = cfg
        self.exec_cfg = exec_cfg or _DEFAULT_EXEC
        self.fc_layers = _fc_stack(cfg.moment_input_dim,
                                   cfg.hidden_dim_moment, cfg.dropout)
        d_last = (cfg.hidden_dim_moment[-1] if cfg.hidden_dim_moment
                  else cfg.moment_input_dim)
        self.output_proj = nn.Linear(d_last, cfg.num_condition_moment)

    def forward(self, macro: Optional[torch.Tensor],
                individual: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                individual_t: Optional[torch.Tensor] = None) -> torch.Tensor:
        """h [K, T, N]; `generator` draws the hidden layers' dropout
        (training), as the JAX MomentNet does. The default net (no hidden
        layer) with macro reads a bf16 feature-major panel `individual_t`
        [T, F, N] where it is given one, as the JAX MomentNet does: one
        contraction, f32 accumulation, the operands in the compute dtype
        on the card and in f32 on the CPU (the JAX rule: its CPU dot has no
        bf16 × bf16 = f32 kernel)."""
        if (individual_t is not None and individual_t.dtype == torch.bfloat16
                and not self.cfg.hidden_dim_moment and macro is not None):
            M = macro.shape[-1]
            w, b = self.output_proj.weight, self.output_proj.bias  # [K, M+F]
            cd = (self.exec_cfg.compute_dtype
                  if individual_t.device.type == "cuda" else "float32")
            # operands rounded to `cd` and kept in f32: every product is
            # exact in f32 and the sum accumulates in f32
            out = torch.einsum("tfn,kf->ktn",
                               sdf_ffn._round(individual_t.float(), cd),
                               sdf_ffn._round(w[:, M:], cd))
            zp_m = macro @ w[:, :M].T + b  # [T, K]
            return torch.tanh(out + zp_m.T[:, :, None])
        linears = [m for m in self.fc_layers if isinstance(m, nn.Linear)]
        linears.append(self.output_proj)
        first = linears[0]
        M = 0 if macro is None else macro.shape[-1]
        # first layer, concat-free: rows [:M] act on macro, [M:] on stocks
        x = individual @ first.weight[:, M:].T + first.bias
        if macro is not None:
            x = x + (macro @ first.weight[:, :M].T)[:, None, :]
        for lin in linears[1:]:
            x = lin(dropout(torch.relu(x), self.cfg.dropout, generator))
        return torch.tanh(x).permute(2, 0, 1)  # [K, T, N]


def moment_output_members(params: Mapping[str, torch.Tensor], cfg: GANConfig
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(k_period [S, M, K], k_stock [S, F, K], bias [S, K]) of every
    member's default MomentNet output layer, from member-stacked
    ``moment_net``-relative params: :func:`moment_output_params` for all
    members at once (one fused conditional-EM call then serves them all)."""
    k = params["output_proj.weight"].transpose(1, 2)  # [S, M + F, K]
    M = cfg.macro_feature_dim
    return k[:, :M], k[:, M:], params["output_proj.bias"]


def moment_h_members(params: Mapping[str, torch.Tensor], cfg: GANConfig,
                     macro: Optional[torch.Tensor], individual: torch.Tensor,
                     generators: Generators = None,
                     shard: Optional[StockShard] = None) -> torch.Tensor:
    """h [S, K, T, N]: :class:`MomentNet` of every member, from
    member-stacked ``moment_net``-relative params (the plain route of a
    moment net with hidden layers). `generators` (one per member) draw the
    hidden layers' dropout; under a stock shard each draw is made at the
    global stock count and cut to the rank's span."""
    n_hidden = len(cfg.hidden_dim_moment)
    layers = [(params[f"fc_layers.{3 * i}.weight"],
               params[f"fc_layers.{3 * i}.bias"]) for i in range(n_hidden)]
    layers.append((params["output_proj.weight"], params["output_proj.bias"]))
    (w0, b0), M = layers[0], (0 if macro is None else macro.shape[-1])
    # first layer, concat-free: columns [:M] act on macro, [M:] on stocks
    x = (individual @ w0[:, None, :, M:].transpose(-1, -2)
         + b0[:, None, None, :])
    if macro is not None:
        x = x + (macro @ w0[:, :, :M].transpose(1, 2))[:, :, None, :]
    span = ((-2, shard.start, shard.stop, shard.n_global)
            if is_sharded(shard) else None)  # x is [S, T, N, H]
    for w, b in layers[1:]:
        x = dropout(torch.relu(x), cfg.dropout, generators, span)
        x = x @ w[:, None].transpose(-1, -2) + b[:, None, None, :]
    return torch.tanh(x).permute(0, 3, 1, 2)  # [S, K, T, N]


def moment_output_params(module: "AssetPricingModule", cfg: GANConfig
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(k_period [M, K], k_stock [F, K], bias [K]) of the default MomentNet
    output layer: the reference's [macro, individual] concat order, rows
    [:M] of the (transposed) weight act on macro, rows [M:] on the stock
    features."""
    proj = module.moment_net.output_proj
    M = cfg.macro_feature_dim
    k = proj.weight.T  # [M + F, K]
    return k[:M], k[M:], proj.bias


class AssetPricingModule(nn.Module):
    """The GAN pair: ``sdf_net`` and ``moment_net``."""

    def __init__(self, cfg: GANConfig, exec_cfg: Optional[ExecutionConfig] = None):
        super().__init__()
        self.cfg = cfg
        self.exec_cfg = exec_cfg or _DEFAULT_EXEC
        self.sdf_net = SDFNet(cfg, self.exec_cfg)
        self.moment_net = MomentNet(cfg, self.exec_cfg)

    def forward(self, macro, individual, mask, individual_t=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(weights [T, N], moments [K, T, N])."""
        return (self.sdf_net(macro, individual, mask, individual_t),
                self.moment_net(macro, individual))


# -- the SimpleSDF baseline --------------------------------------------------


class SimpleSDF(nn.Module):
    """The non-adversarial FFN-only SDF baseline (the JAX package's
    ``SimpleSDF``): concat ``[macro tiled, individual]`` → FFN (ReLU,
    dropout) → Linear(1) → mask → cross-sectional zero-mean, always.

    The first layer runs concat-free in the other order from
    :class:`SDFNet`'s: columns [:M] of its weight act on the macro, so the
    fused FFN takes ``k1T = W[:, M:]`` and the per-period bias ``zp = macro
    @ W[:, :M]ᵀ + b`` (``b`` alone without macro, ``macro_dim`` 0). With
    hidden layers the FFN is one :func:`..ops.sdf_ffn.sdf_ffn` call at
    S = 1 (the kernels on a CUDA panel, their plain versions on the CPU);
    the module names are the port's own (the JAX package writes no ``.pt``
    of it): ``fc_layers.{3i}`` and ``output_proj``."""

    def __init__(self, macro_dim: int, individual_dim: int,
                 hidden_dims: Sequence[int] = (64, 64), dropout: float = 0.05,
                 exec_cfg: Optional[ExecutionConfig] = None):
        super().__init__()
        self.macro_dim, self.individual_dim = int(macro_dim), int(individual_dim)
        self.hidden_dims = tuple(int(h) for h in hidden_dims)
        self.dropout = float(dropout)
        self.exec_cfg = exec_cfg or _DEFAULT_EXEC
        d_in = self.macro_dim + self.individual_dim
        self.fc_layers = _fc_stack(d_in, self.hidden_dims, self.dropout)
        self.output_proj = nn.Linear(
            self.hidden_dims[-1] if self.hidden_dims else d_in, 1)

    def forward(self, macro: Optional[torch.Tensor], individual: torch.Tensor,
                mask: torch.Tensor, individual_t: Optional[torch.Tensor] = None,
                seed: Optional[int] = None) -> torch.Tensor:
        """Weights [T, N]; `seed` turns dropout on (training) and draws its
        masks, as :meth:`SDFNet.forward` does."""
        M = self.macro_dim
        if (macro is None) != (M == 0):
            raise ValueError(f"SimpleSDF built for macro_dim {M} got "
                             f"{'no' if macro is None else 'a'} macro")
        if individual_t is None:
            individual_t = individual.permute(0, 2, 1).contiguous()
        T = individual_t.shape[0]
        linears = [m for m in self.fc_layers if isinstance(m, nn.Linear)]
        first = linears[0] if linears else self.output_proj
        zp = first.bias.expand(T, first.bias.shape[0])
        if macro is not None:
            zp = zp + macro @ first.weight[:, :M].T
        k1T = first.weight[:, M:]
        if not self.hidden_dims:
            raw = torch.einsum("f,tfn->tn", k1T[0], individual_t) + zp
        else:
            training = seed is not None and self.dropout > 0.0
            cfg = self.exec_cfg
            raw = sdf_ffn.sdf_ffn(
                individual_t, zp.contiguous()[None], k1T[None],
                [(m.weight[None], m.bias[None]) for m in linears[1:]],
                self.output_proj.weight, self.output_proj.bias,
                seed=seed if training else 0,
                dropout_rate=self.dropout if training else 0.0,
                compute_dtype=cfg.compute_dtype, kernel=cfg.kernel)[0]
        return masked_zero_mean(raw * mask, mask)


def simple_sdf_forward(model: SimpleSDF, batch: Mapping[str, torch.Tensor],
                       seed: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """SimpleSDF's loss-bearing forward (the JAX package's
    ``simple_sdf_forward``): the weights, the UNWEIGHTED portfolio returns
    (no N̄/N_t scaling, unlike the GAN loss), the unconditional loss, and
    the (std + 1e-8)-guarded monitoring Sharpe (ddof 1). `seed` turns
    dropout on; None is the eval forward."""
    mask, returns = batch["mask"], batch["returns"]
    weights = model(batch.get("macro"), batch["individual"], mask,
                    individual_t=batch.get("individual_t"), seed=seed)
    loss, port = unconditional_loss(weights, returns, mask, weighted=False,
                                    n_assets=batch.get("n_assets"))
    return {"weights": weights, "loss": loss,
            "sharpe": sharpe_monitor(port), "portfolio_returns": port}
