"""Training NN weights by diffusion instead of SGD (port of
``mbd_tpu/blackbox/mnist.py``; reference: mbd/blackbox/mbd_mnist.py).

A 784-32-32-10 MLP classifier whose parameters are optimized by the MBD
reverse process: each step perturbs a population of Nsample parameter
sets with per-parameter Gaussian noise gated by a Bernoulli(0.2) mask
(the first layer's noise scaled by 0.1), scores each member by its
cross-entropy on a random batch of ``batch_size`` training rows drawn
without replacement, and collapses to the softmax-weighted average of the
population (the scores standardized, at temperature 0.3). Schedule:
``core/schedule.py`` with betas from 3e-5 to 1e-3 over 500 steps.

The population's forward pass is one batched product over the Nsample
axis (``torch.matmul``): JAX computes it with XLA outside any Pallas
kernel, and so no kernel of the port's runs here.

Data: real MNIST from ``MBD_TPU_MNIST_DIR`` (the standard
``*-idx?-ubyte.gz`` files) when it is set, else scikit-learn's 8×8
digits, committed as ``assets/digits.npz`` and upsampled, cropped and
split exactly as the JAX package does it. Rewrite the asset with

    python -m mbd_tpu_torch.blackbox.mnist --make_asset

(this alone needs scikit-learn). Random numbers come from an explicit
``torch.Generator``; ``draws`` replaces them (the tests feed JAX's
through it).
"""

from __future__ import annotations

import argparse
import array
import gzip
import os
import struct
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..core.schedule import make_schedule
from ..device import DEFAULT, resolve

ASSET = os.path.join(os.path.dirname(os.path.dirname(__file__)), "assets",
                     "digits.npz")
LAYER_SIZES = (784, 32, 32, 10)

Params = List[Tuple[torch.Tensor, torch.Tensor]]


def _load_idx_dir(d: str):
    def parse_labels(fn):
        with gzip.open(fn, "rb") as fh:
            struct.unpack(">II", fh.read(8))
            return np.array(array.array("B", fh.read()), dtype=np.uint8)

    def parse_images(fn):
        with gzip.open(fn, "rb") as fh:
            _, num, rows, cols = struct.unpack(">IIII", fh.read(16))
            return np.array(array.array("B", fh.read()),
                            dtype=np.uint8).reshape(num, rows * cols)

    return (parse_images(os.path.join(d, "train-images-idx3-ubyte.gz")),
            parse_labels(os.path.join(d, "train-labels-idx1-ubyte.gz")),
            parse_images(os.path.join(d, "t10k-images-idx3-ubyte.gz")),
            parse_labels(os.path.join(d, "t10k-labels-idx1-ubyte.gz")))


def make_asset(path: str = ASSET) -> None:
    """scikit-learn's 8×8 digits (1797 images, values 0–16, and labels)
    into ``path``."""
    from sklearn.datasets import load_digits

    X, y = load_digits(return_X_y=True)
    np.savez_compressed(path, X=X.astype(np.uint8), y=y.astype(np.uint8))
    print(f"wrote {path}: {X.shape[0]} digits")


def _load_digits_as_mnist():
    """The committed digits as 28×28 images: each pixel repeated 4×4, the
    centre 28² of the 32² kept, 80 % of the rows (a fixed permutation) for
    training."""
    with np.load(ASSET) as f:
        X, y = f["X"].astype(np.float64), f["y"].astype(np.int64)
    X = (X / 16.0).reshape(-1, 8, 8)
    X28 = np.repeat(np.repeat(X, 4, axis=1), 4, axis=2)
    X28 = X28[:, 2:30, 2:30].reshape(-1, 784)
    n = len(X28)
    n_train = int(0.8 * n)
    perm = np.random.RandomState(0).permutation(n)
    tr, te = perm[:n_train], perm[n_train:]
    return (X28[tr] * 255, y[tr], X28[te] * 255, y[te])


def load_dataset() -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(train x [n, 784] in [0, 1], train one-hot labels [n, 10], test x,
    test labels), float32."""
    d = os.environ.get("MBD_TPU_MNIST_DIR")
    if d and os.path.isdir(d):
        tr_x, tr_y, te_x, te_y = _load_idx_dir(d)
    else:
        tr_x, tr_y, te_x, te_y = _load_digits_as_mnist()

    def one_hot(y):
        return np.eye(10, dtype=np.float32)[np.asarray(y, int)]

    return (np.asarray(tr_x, np.float32) / 255.0, one_hot(tr_y),
            np.asarray(te_x, np.float32) / 255.0, one_hot(te_y))


def init_params(generator: torch.Generator) -> Params:
    """Each layer's W [fan_in, fan_out] ~ N(0, 1/fan_in) and b = 0, on the
    generator's device."""
    params = []
    for fan_in, fan_out in zip(LAYER_SIZES[:-1], LAYER_SIZES[1:]):
        W = torch.randn((fan_in, fan_out), generator=generator,
                        device=generator.device) * (1.0 / fan_in) ** 0.5
        params.append((W, torch.zeros(fan_out, device=generator.device)))
    return params


def predict(params: Params, x: torch.Tensor) -> torch.Tensor:
    """Log-probabilities [..., B, 10] of x [B, 784]; the parameters may
    carry a leading population axis (W [Ns, fan_in, fan_out], b [Ns,
    fan_out]), which then leads the output."""
    for W, b in params[:-1]:
        x = torch.relu(torch.matmul(x, W) + b[..., None, :])
    W, b = params[-1]
    return torch.log_softmax(torch.matmul(x, W) + b[..., None, :], dim=-1)


def loss(params: Params, batch) -> torch.Tensor:
    """The mean cross-entropy (per member of a population)."""
    inputs, targets = batch
    return -(predict(params, inputs) * targets).sum(dim=-1).mean(dim=-1)


def accuracy(params: Params, batch) -> torch.Tensor:
    inputs, targets = batch
    return (predict(params, inputs).argmax(dim=-1)
            == targets.argmax(dim=-1)).float().mean(dim=-1)


@dataclass
class MnistDiffusionConfig:
    Nsample: int = 256
    Ndiffuse: int = 500
    temp_sample: float = 0.3
    beta0: float = 3e-5
    betaT: float = 1e-3
    gibbs_p: float = 0.2       # Bernoulli mask rate on noise
    first_layer_scale: float = 0.1
    batch_size: int = 256      # data rows per objective evaluation


class Draws:
    """Every random draw of ``train`` from one generator, by kind; a test
    passes an object with these methods that returns JAX's draws."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def batch(self, ndata: int, n: int) -> torch.Tensor:
        """n row indices of [0, ndata), without replacement."""
        return torch.randperm(ndata, generator=self.generator,
                              device=self.generator.device)[:n]

    def normal(self, shape) -> torch.Tensor:
        return torch.randn(shape, generator=self.generator,
                           device=self.generator.device)

    def mask(self, p: float, shape) -> torch.Tensor:
        """Bernoulli(p) draws as booleans."""
        return torch.rand(shape, generator=self.generator,
                          device=self.generator.device) < p


def train(cfg: MnistDiffusionConfig, generator: torch.Generator,
          data=None, params: Optional[Params] = None,
          draws: Optional[Draws] = None):
    """Diffuse the MLP's weights on the generator's device; returns
    (params, (J [Ndiffuse − 1], test accuracy [Ndiffuse − 1])), each
    step's mean population score and the collapsed parameters' test
    accuracy. ``params`` (default ``init_params(generator)``) and
    ``draws`` (default: ``Draws(generator)``) are taken as given; each
    step draws its batch, then each layer's W noise, W mask, b noise and
    b mask in turn."""
    device = generator.device
    if data is None:
        data = load_dataset()
    train_x, train_y, test_x, test_y = [torch.as_tensor(a, device=device)
                                        for a in data]
    ndata = train_x.shape[0]
    sched = make_schedule(cfg.Ndiffuse, cfg.beta0, cfg.betaT, device=device)
    params = params if params is not None else init_params(generator)
    draws = draws or Draws(generator)
    n = cfg.Nsample

    def perturb(params, sigma):
        out = []
        for li, (W, b) in enumerate(params):
            scale = cfg.first_layer_scale if li == 0 else 1.0
            nW = draws.normal((n,) + W.shape) * sigma * scale
            mW = draws.mask(cfg.gibbs_p, (n,) + W.shape)
            nb = draws.normal((n,) + b.shape) * sigma
            mb = draws.mask(cfg.gibbs_p, (n,) + b.shape)
            out.append((W + nW * mW, b + nb * mb))
        return out

    Js_trace, accs = [], []
    for t in range(cfg.Ndiffuse - 1, 0, -1):
        idx = draws.batch(ndata, min(cfg.batch_size, ndata))
        Y0s = perturb(params, sched.sigmas[t])
        Js = -loss(Y0s, (train_x[idx], train_y[idx]))
        logp0 = (Js - Js.mean()) / torch.clamp_min(
            Js.std(correction=0), 1e-8) / cfg.temp_sample
        w = torch.softmax(logp0, dim=0)
        params = [(torch.tensordot(w, W, dims=1), torch.tensordot(w, b,
                                                                  dims=1))
                  for W, b in Y0s]
        Js_trace.append(Js.mean())
        accs.append(accuracy(params, (test_x, test_y)))
    return params, (torch.stack(Js_trace), torch.stack(accs))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--make_asset", action="store_true",
                   help="write assets/digits.npz from scikit-learn")
    p.add_argument("--seeds", type=int, default=1)
    p.add_argument("--device", default=DEFAULT)
    args = p.parse_args(argv)
    if args.make_asset:
        make_asset()
        return
    device = resolve(args.device)
    cfg = MnistDiffusionConfig()
    for seed in range(args.seeds):
        _, (J, acc) = train(cfg, torch.Generator(device).manual_seed(seed))
        print(f"seed {seed}: test accuracy {float(acc[-1]):.4f}, "
              f"J {float(J[-1]):.6f}")


if __name__ == "__main__":
    main()
