"""Policy / value networks and running observation normalization (port of
``mbd_tpu/rl/networks.py``).

The PPO policy MLP (32,)×4 emits (mu, log_sigma) of a tanh-squashed
Normal; the PPO value MLP is (256,)×5; SAC's actor and twin critic have
(256, 256) torsos. Weights are initialised as flax's ``lecun_uniform``,
U(±√(3/fan_in)), with zero biases, and the activation is swish (SiLU).

The noise of every draw is an argument, so that a caller (or a test) can
pass any stream's draws. Params travel as flax's tree: ``to_tree`` and
``load_tree`` turn a params dataclass into nested dicts of numpy arrays
keyed as flax keys them (``policy/params/MLP_0/Dense_0/kernel``, a
``Dense`` kernel [in, out], the transpose of ``nn.Linear``'s weight), and
``save_npz`` / ``load_npz`` keep that tree as one ``.npz`` with the key
paths flattened, so that a converted JAX checkpoint and the port's own are
one format.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, fields
from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

_LOG_SIG_MIN, _LOG_SIG_MAX = -5.0, 2.0
_LOG_2PI = math.log(2.0 * math.pi)
_LOG_2 = math.log(2.0)


class MLP(nn.Module):
    """Dense layers with swish between them (not after the last)."""

    def __init__(self, in_size: int, layer_sizes: Sequence[int],
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        sizes = [in_size] + list(layer_sizes)
        self.layers = nn.ModuleList(
            nn.Linear(a, b) for a, b in zip(sizes[:-1], sizes[1:]))
        with torch.no_grad():
            for lin in self.layers:
                lim = math.sqrt(3.0 / lin.in_features)
                lin.weight.uniform_(-lim, lim, generator=generator)
                lin.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, lin in enumerate(self.layers):
            x = lin(x)
            if i < len(self.layers) - 1:
                x = nn.functional.silu(x)
        return x


class PolicyNet(nn.Module):
    def __init__(self, obs_size: int, action_size: int,
                 hidden: Sequence[int] = (32, 32, 32, 32),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.mlps = nn.ModuleList([MLP(obs_size, list(hidden) +
                                       [2 * action_size], generator)])

    def forward(self, obs):
        mu, log_sigma = self.mlps[0](obs).chunk(2, dim=-1)
        return mu, log_sigma


class ValueNet(nn.Module):
    def __init__(self, obs_size: int,
                 hidden: Sequence[int] = (256, 256, 256, 256, 256),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.mlps = nn.ModuleList([MLP(obs_size, list(hidden) + [1],
                                       generator)])

    def forward(self, obs):
        return self.mlps[0](obs).squeeze(-1)


class QNet(nn.Module):
    """Twin Q network (SAC)."""

    def __init__(self, obs_size: int, action_size: int,
                 hidden: Sequence[int] = (256, 256),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.mlps = nn.ModuleList(
            MLP(obs_size + action_size, list(hidden) + [1], generator)
            for _ in range(2))

    def forward(self, obs, act):
        x = torch.cat([obs, act], dim=-1)
        return self.mlps[0](x).squeeze(-1), self.mlps[1](x).squeeze(-1)


# --- tanh-squashed Normal ---------------------------------------------------

def sample_action(mu, log_sigma, noise):
    """(action in [−1, 1], log_prob, pre-tanh sample) for the standard
    normal draws ``noise`` (mu's shape)."""
    sigma = torch.exp(torch.clamp(log_sigma, _LOG_SIG_MIN, _LOG_SIG_MAX))
    pre = mu + sigma * noise
    logp = _normal_logp(pre, mu, sigma) - _tanh_correction(pre)
    return torch.tanh(pre), logp.sum(-1), pre


def log_prob(mu, log_sigma, pre_tanh):
    sigma = torch.exp(torch.clamp(log_sigma, _LOG_SIG_MIN, _LOG_SIG_MAX))
    return (_normal_logp(pre_tanh, mu, sigma)
            - _tanh_correction(pre_tanh)).sum(-1)


def entropy_estimate(mu, log_sigma, noise):
    """Sampled entropy of the squashed distribution (brax-style)."""
    return -sample_action(mu, log_sigma, noise)[1]


def deterministic_action(mu, log_sigma):
    return torch.tanh(mu)


def _normal_logp(x, mu, sigma):
    return -0.5 * ((x - mu) / sigma) ** 2 - torch.log(sigma) - 0.5 * _LOG_2PI


def _tanh_correction(pre):
    # log |d tanh / dx| = log(1 − tanh²) = 2(log 2 − pre − softplus(−2 pre))
    return 2.0 * (_LOG_2 - pre - torch.logaddexp(-2.0 * pre,
                                                 torch.zeros_like(pre)))


def make_norm(cfg, params):
    """obs → obs normalised by ``params.obs_stats`` as they are now, when
    ``cfg.normalize_observations``."""
    if cfg.normalize_observations:
        return params.obs_stats.normalize
    return lambda obs: obs


def make_inference_fn(cfg, params, deterministic: bool = True):
    """The policy of a trainer's params (PPO's or SAC's): obs → tanh(mu),
    or with ``deterministic`` False, (obs, noise) → a sampled action."""
    norm = make_norm(cfg, params)

    @torch.no_grad()
    def inference(obs, noise=None):
        mu, log_sigma = params.policy(norm(obs))
        if deterministic:
            return deterministic_action(mu, log_sigma)
        return sample_action(mu, log_sigma, noise)[0]
    return inference


# --- running observation normalization --------------------------------------

@dataclass
class RunningStats:
    count: torch.Tensor
    mean: torch.Tensor
    m2: torch.Tensor

    @classmethod
    def create(cls, obs_size: int, device) -> "RunningStats":
        return cls(count=torch.zeros((), device=device),
                   mean=torch.zeros(obs_size, device=device),
                   m2=torch.zeros(obs_size, device=device))

    def update(self, batch: torch.Tensor) -> "RunningStats":
        """Chan's parallel Welford merge over all leading axes of
        ``batch``."""
        flat = batch.reshape(-1, batch.shape[-1])
        n_b = flat.shape[0]
        mu_b = flat.mean(0)
        m2_b = ((flat - mu_b) ** 2).sum(0)
        n_new = self.count + n_b
        delta = mu_b - self.mean
        return RunningStats(
            count=n_new, mean=self.mean + delta * n_b / n_new,
            m2=self.m2 + m2_b + delta ** 2 * self.count * n_b / n_new)

    def normalize(self, obs: torch.Tensor) -> torch.Tensor:
        var = self.m2 / torch.clamp_min(self.count, 1.0)
        return (obs - self.mean) / torch.sqrt(var + 1e-6)


# --- params as flax's tree -------------------------------------------------

def net_tree(net: nn.Module) -> Dict:
    """A network's params as flax's ``{"params": {"MLP_i": {"Dense_k":
    {"kernel", "bias"}}}}``."""
    return {"params": {
        f"MLP_{i}": {f"Dense_{k}": {
            "kernel": lin.weight.detach().cpu().numpy().T.copy(),
            "bias": lin.bias.detach().cpu().numpy().copy()}
            for k, lin in enumerate(mlp.layers)}
        for i, mlp in enumerate(net.mlps)}}


def load_net_tree(net: nn.Module, tree: Dict) -> None:
    """Copy a flax params tree into ``net`` (shapes must match)."""
    with torch.no_grad():
        for i, mlp in enumerate(net.mlps):
            for k, lin in enumerate(mlp.layers):
                dense = tree["params"][f"MLP_{i}"][f"Dense_{k}"]
                lin.weight.copy_(torch.tensor(np.array(dense["kernel"]).T))
                lin.bias.copy_(torch.tensor(np.array(dense["bias"])))


def to_tree(params) -> Dict:
    """A params dataclass (networks, ``RunningStats``, tensors) as the
    tree flax serialises for the JAX package's dataclass of the same
    fields."""
    out = {}
    for f in fields(params):
        v = getattr(params, f.name)
        if isinstance(v, nn.Module):
            out[f.name] = net_tree(v)
        elif isinstance(v, RunningStats):
            out[f.name] = {k: getattr(v, k).detach().cpu().numpy()
                           for k in ("count", "mean", "m2")}
        else:
            out[f.name] = v.detach().cpu().numpy()
    return out


def load_tree(params, tree: Dict) -> None:
    """Copy ``tree`` (as ``to_tree`` gives it) into ``params`` in place."""
    with torch.no_grad():
        for f in fields(params):
            v, sub = getattr(params, f.name), tree[f.name]
            if isinstance(v, nn.Module):
                load_net_tree(v, sub)
            elif isinstance(v, RunningStats):
                for k in ("count", "mean", "m2"):
                    getattr(v, k).copy_(torch.tensor(np.array(sub[k])))
            else:
                v.copy_(torch.tensor(np.array(sub)))


def flatten(tree: Dict, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def unflatten(flat: Dict[str, np.ndarray]) -> Dict:
    tree: Dict = {}
    for path, v in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def save_npz(path: str, tree: Dict) -> None:
    with open(path, "wb") as f:
        np.savez(f, **flatten(tree))


def load_npz(path: str) -> Dict:
    with np.load(path) as d:
        return unflatten({k: d[k] for k in d.files})


# --- the random draws of a training run ------------------------------------

class Draws:
    """Every random draw of a training run, by kind, from one
    ``torch.Generator`` (on the device the draws are used on). JAX splits a
    key per draw; a test replays those draws by passing an object with
    these methods that returns JAX's."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def _normal(self, shape):
        return torch.randn(shape, generator=self.generator,
                           device=self.generator.device)

    def action(self, shape):
        """The noise of the actions of one env step."""
        return self._normal(shape)

    def entropy(self, shape):
        """The noise of PPO's entropy estimate for one minibatch."""
        return self._normal(shape)

    def critic(self, shape):
        """The noise of SAC's next actions in the critic's target."""
        return self._normal(shape)

    def actor(self, shape):
        """The noise of SAC's actions in the actor's loss."""
        return self._normal(shape)

    def permutation(self, n: int):
        """PPO's shuffle of one epoch's data."""
        return torch.randperm(n, generator=self.generator,
                              device=self.generator.device)

    def indices(self, high: int, n: int):
        """SAC's sample of n rows of the replay buffer's first ``high``."""
        return torch.randint(0, max(high, 1), (n,), generator=self.generator,
                             device=self.generator.device)
