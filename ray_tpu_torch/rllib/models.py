"""Model catalog: networks on plain tensor trees (reference:
rllib/models/catalog.py — the fcnet/visionnet/lstm model zoo + action
distributions).

Parameters are trees of tensors in the JAX package's layout (lists of
``(W [din, dout], b)`` tuples, dicts of those), and apply functions are
plain functions on tensors, so a policy's update builds new tensors and
rebinds its tree, and ES can flatten a whole tree into one vector.
Networks:

  MLP        — init_mlp / apply_mlp (the fcnet default)
  ConvNet    — init_convnet / apply_convnet (visionnet: NHWC at the API and
               HWIO weights in the tree, NCHW and OIHW inside, XLA's SAME
               padding; flatten, dense head)
  LSTM       — init_lstm / apply_lstm (use_lstm wrapper: one fused gate
               matmul a step, a loop over time)

Action distributions (rllib/models/action_dist.py): Categorical for
discrete policies and DiagGaussian (plain Gaussian — squashing policies
must correct their own logp) for continuous — sample/logp/entropy as plain
functions. Random draws come from an explicit ``torch.Generator`` where the
JAX package takes a PRNG key; the device of a network's tensors is its
generator's.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F


def init_mlp(gen: torch.Generator, sizes: Sequence[int]
             ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """He-initialized MLP params: [(W, b), ...] on ``gen``'s device."""
    params = []
    for din, dout in zip(sizes[:-1], sizes[1:]):
        w = torch.randn((din, dout), generator=gen, device=gen.device) \
            * math.sqrt(2.0 / din)
        params.append((w, torch.zeros(dout, device=gen.device)))
    return params


def apply_mlp(params, x: torch.Tensor) -> torch.Tensor:
    for w, b in params[:-1]:
        x = torch.tanh(x @ w + b)
    w, b = params[-1]
    return x @ w + b


def _leaves(tree) -> list:
    """Every leaf of ``tree`` in JAX's order: dicts by sorted key, lists
    and tuples by index."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def num_params(params) -> int:
    return sum(int(p.numel()) for p in _leaves(params))


def flatten_params(params) -> torch.Tensor:
    """Every leaf in the JAX package's order (W0, b0, W1, b1, ...; dicts by
    sorted key), as one vector."""
    return torch.cat([p.reshape(-1) for p in _leaves(params)])


def unflatten_like(flat: torch.Tensor, params):
    """``flat`` cut into leaves of ``params``' shapes, in its tree."""
    offset = 0

    def build(tree):
        nonlocal offset
        if isinstance(tree, dict):
            out = {k: build(tree[k]) for k in sorted(tree)}
            return {k: out[k] for k in tree}
        if isinstance(tree, (list, tuple)):
            out = [build(v) for v in tree]
            return type(tree)(out) if isinstance(tree, tuple) else out
        leaf = flat[offset:offset + tree.numel()].reshape(tree.shape)
        offset += tree.numel()
        return leaf

    return build(params)


# ---------------------------------------------------------------------------
# ConvNet (reference: rllib/models/tf/visionnet.py) — NHWC at the API.
# filters: [(out_channels, kernel, stride), ...]; dense head sizes appended.
# ---------------------------------------------------------------------------

DEFAULT_FILTERS = [(16, 4, 2), (32, 4, 2)]


def init_convnet(gen: torch.Generator, input_shape: Sequence[int],
                 filters: Sequence[Tuple[int, int, int]] = None,
                 head_sizes: Sequence[int] = (64,),
                 num_outputs: int = 2):
    """input_shape = (H, W, C). Returns (params, strides): strides are
    static config, kept out of the parameter tree. Conv weights are HWIO,
    as the JAX package's, so a tree carries across."""
    filters = list(filters or DEFAULT_FILTERS)
    H, W, C = input_shape
    conv_params = []
    strides = []
    cin = C
    for cout, k, s in filters:
        fan_in = k * k * cin
        w = torch.randn((k, k, cin, cout), generator=gen,
                        device=gen.device) * math.sqrt(2.0 / fan_in)
        conv_params.append((w, torch.zeros(cout, device=gen.device)))
        strides.append(s)
        H = -(-H // s)
        W = -(-W // s)
        cin = cout
    head = init_mlp(gen, [H * W * cin, *head_sizes, num_outputs])
    return {"conv": conv_params, "head": head}, tuple(strides)


def _same_pads(size: int, k: int, s: int) -> Tuple[int, int]:
    """XLA's SAME padding of one spatial dimension: the output has
    ceil(size / s) positions; of an odd total pad, the extra pixel goes
    after."""
    total = max((-(-size // s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def apply_convnet(params: Dict, x: torch.Tensor,
                  strides: Sequence[int] = None) -> torch.Tensor:
    """x: [B, H, W, C] float -> [B, num_outputs]."""
    if strides is None:
        strides = [s for _, _, s in DEFAULT_FILTERS]
    if len(strides) != len(params["conv"]):
        raise ValueError(
            f"{len(params['conv'])} conv layers but {len(strides)} strides "
            f"— pass the strides returned by init_convnet")
    x = x.permute(0, 3, 1, 2)                          # NHWC -> NCHW
    for (w, b), stride in zip(params["conv"], strides):
        k_h, k_w = w.shape[0], w.shape[1]
        top, bottom = _same_pads(x.shape[2], k_h, stride)
        left, right = _same_pads(x.shape[3], k_w, stride)
        x = F.pad(x, (left, right, top, bottom))
        x = F.conv2d(x, w.permute(3, 2, 0, 1), b, stride=stride)  # OIHW
        x = torch.relu(x)
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # flatten as NHWC
    return apply_mlp(params["head"], x)


# ---------------------------------------------------------------------------
# LSTM wrapper (reference: rllib/models/tf/recurrent_net.py use_lstm) —
# one fused gate matmul per step, a loop over time.
# ---------------------------------------------------------------------------


def init_lstm(gen: torch.Generator, input_dim: int, hidden: int,
              num_outputs: int) -> Dict:
    scale = math.sqrt(1.0 / (input_dim + hidden))
    dev = gen.device
    return {
        "wx": torch.randn((input_dim, 4 * hidden), generator=gen,
                          device=dev) * scale,
        "wh": torch.randn((hidden, 4 * hidden), generator=gen,
                          device=dev) * scale,
        "b": torch.zeros(4 * hidden, device=dev),
        "head": init_mlp(gen, [hidden, num_outputs]),
    }


def lstm_initial_state(hidden: int, batch: int, device=None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    return (torch.zeros((batch, hidden), device=device),
            torch.zeros((batch, hidden), device=device))


def apply_lstm(params: Dict, xs: torch.Tensor, state=None):
    """xs: [B, T, D] -> (logits [B, T, num_outputs], final (h, c)).

    A loop over T; the state carried in continues the sequence."""
    B, T, _ = xs.shape
    hidden = params["wh"].shape[0]
    if state is None:
        state = lstm_initial_state(hidden, B, device=xs.device)
    h, c = state
    hs = []
    for t in range(T):
        gates = xs[:, t] @ params["wx"] + h @ params["wh"] + params["b"]
        i, f, g, o = torch.split(gates, hidden, dim=-1)
        c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        hs.append(h)
    logits = apply_mlp(params["head"], torch.stack(hs, dim=1))
    return logits, (h, c)


# ---------------------------------------------------------------------------
# Action distributions (reference: rllib/models/tf/tf_action_dist.py) —
# plain functions over parameter tensors.
# ---------------------------------------------------------------------------


def gumbel_argmax(gen: torch.Generator, logits: torch.Tensor) -> torch.Tensor:
    """A draw of Categorical(logits) over the last axis: the argmax of the
    logits plus Gumbel noise, as ``jax.random.categorical`` draws (its
    bits are the generator's)."""
    u = torch.rand(logits.shape, generator=gen, device=logits.device)
    tiny = torch.finfo(logits.dtype).tiny
    return torch.argmax(logits - torch.log(-torch.log(u.clamp_min(tiny))),
                        dim=-1)


class Categorical:
    @staticmethod
    def sample(gen, logits):
        return gumbel_argmax(gen, logits)

    @staticmethod
    def logp(logits, actions):
        logp_all = torch.log_softmax(logits, dim=-1)
        return torch.gather(logp_all, -1,
                            actions[..., None].long())[..., 0]

    @staticmethod
    def entropy(logits):
        logp = torch.log_softmax(logits, dim=-1)
        return -torch.sum(torch.exp(logp) * logp, dim=-1)


class DiagGaussian:
    """mean/log_std parameterization. Deliberately NO tanh-squash option:
    a squashed sample needs the -log(1 - a^2) Jacobian term in logp, which
    this plain-Gaussian logp does not apply (SAC-style policies squash
    explicitly and correct their own logp; DDPG/TD3 use a deterministic
    tanh actor with additive noise, no density needed)."""

    @staticmethod
    def sample(gen, mean, log_std):
        return mean + torch.exp(log_std) * torch.randn(
            mean.shape, generator=gen, device=mean.device)

    @staticmethod
    def logp(mean, log_std, actions):
        var = torch.exp(2 * log_std)
        return torch.sum(
            -0.5 * ((actions - mean) ** 2 / var + 2 * log_std
                    + math.log(2 * math.pi)),
            dim=-1)

    @staticmethod
    def entropy(log_std):
        return torch.sum(log_std + 0.5 * math.log(2 * math.pi * math.e),
                         dim=-1)
