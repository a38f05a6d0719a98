"""MNIST weight diffusion (``mbd_tpu_torch/blackbox/mnist.py``) against the
JAX package's ``mbd_tpu/blackbox/mnist.py``, on the CPU.

The data loader equals JAX's bit for bit, from the committed digits
against scikit-learn's. The network's forward pass, loss and accuracy
agree on JAX's parameters to rtol 1e-6. ``train`` handed JAX's own draws
(reproduced from ``PRNGKey(0)`` by JAX's split order) and JAX's initial
parameters follows JAX's run at Nsample 16 for 10 steps: J to 5e-6 and
the parameters to 5e-5 absolute (measured on the CPU: 9.5e-7 and 1.2e-5;
the two packages' float32 products sum in different orders, and the
softmax at temperature 0.3 of the standardized scores carries those
rounding differences into the weights), and the same count of test rows
right after every step.

    PYTHONPATH=. python tests/test_torch_mnist.py --reference

writes JAX's final test accuracy and J over seeds 0–5 at the published
config (Nsample 256, Ndiffuse 500) into ``mbd_tpu_torch/assets/
mnist_jax.json``, which ``chip_smoke.py`` holds the card's 6-seed mean
against.
"""

import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mbd_tpu.blackbox import mnist as jmnist
from mbd_tpu_torch.blackbox import mnist

REFERENCE = os.path.join(os.path.dirname(mnist.ASSET), "mnist_jax.json")
J_ATOL = 5e-6
PARAM_ATOL = 5e-5


@pytest.fixture(scope="module")
def data():
    return mnist.load_dataset()


def test_load_dataset_matches_jax(monkeypatch, data):
    monkeypatch.delenv("MBD_TPU_MNIST_DIR", raising=False)
    ref = jmnist.load_dataset()
    for a, b in zip(data, ref):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert data[0].shape == (1437, 784) and data[2].shape == (360, 784)


def _to_torch(params):
    return [(torch.from_numpy(np.array(W)), torch.from_numpy(np.array(b)))
            for W, b in params]


def test_predict_loss_accuracy_match_jax(data):
    """On JAX's initial parameters (its bias perturbed, so that it counts)
    and on a population of 4 perturbed copies."""
    params = jmnist.init_params(jax.random.PRNGKey(1))
    params = [(W, b + 0.1 * jax.random.normal(jax.random.PRNGKey(i),
                                              b.shape))
              for i, (W, b) in enumerate(params)]
    x, y = data[2][:64], data[3][:64]
    tp = _to_torch(params)
    batch = (torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(mnist.predict(tp, batch[0]).numpy(),
                               np.asarray(jmnist.predict(params, x)),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(mnist.loss(tp, batch)),
                               float(jmnist.loss(params, (x, y))), rtol=1e-6)
    assert float(mnist.accuracy(tp, batch)) == float(
        jmnist.accuracy(params, (x, y)))
    pop = [(jnp.stack([W * (1.0 + 0.01 * k) for k in range(4)]),
            jnp.stack([b - 0.01 * k for k in range(4)])) for W, b in params]
    np.testing.assert_allclose(
        mnist.loss(_to_torch(pop), batch).numpy(),
        np.asarray(jax.vmap(jmnist.loss, in_axes=(0, None))(pop, (x, y))),
        rtol=1e-6)


class JaxDraws:
    """JAX's draws of ``jmnist.train`` at ``cfg`` from ``rng``, served in
    the order the port's ``train`` asks for them, and its initial
    parameters: split(rng) → (rng, k_init); per step split(rng, 3) →
    (rng, k_noise, k_batch), the batch from k_batch, and per layer
    split(k, 5) → (k, k1, k2, k3, k4): W noise, W mask, b noise, b mask
    (mbd_tpu/blackbox/mnist.py:136-153, 170)."""

    def __init__(self, cfg, rng, ndata):
        rng, k_init = jax.random.split(rng)
        self.params = jmnist.init_params(k_init)
        self.steps = []
        for _ in range(cfg.Ndiffuse - 1):
            rng, k_noise, k_batch = jax.random.split(rng, 3)
            idx = jax.random.choice(k_batch, ndata,
                                    (min(cfg.batch_size, ndata),),
                                    replace=False)
            normals, masks = [], []
            k = k_noise
            for W, b in self.params:
                k, k1, k2, k3, k4 = jax.random.split(k, 5)
                n = cfg.Nsample
                normals += [jax.random.normal(k1, (n,) + W.shape),
                            jax.random.normal(k3, (n,) + b.shape)]
                masks += [jax.random.bernoulli(k2, cfg.gibbs_p,
                                               (n,) + W.shape),
                          jax.random.bernoulli(k4, cfg.gibbs_p,
                                               (n,) + b.shape)]
            self.steps.append((idx, normals, masks))
        self._steps = iter(self.steps)

    def batch(self, ndata, n):
        idx, normals, masks = next(self._steps)
        self._normals = iter(normals)
        self._masks = iter(masks)
        return torch.from_numpy(np.array(idx)).long()

    def normal(self, shape):
        out = torch.from_numpy(np.array(next(self._normals)))
        assert tuple(out.shape) == tuple(shape)
        return out

    def mask(self, p, shape):
        out = torch.from_numpy(np.array(next(self._masks)))
        assert tuple(out.shape) == tuple(shape)
        return out


def test_train_with_jax_draws_follows_jax(data):
    cfg = jmnist.MnistDiffusionConfig(Nsample=16, Ndiffuse=11)
    ref_params, (ref_J, ref_acc) = jmnist.train(cfg, jax.random.PRNGKey(0),
                                                data=data)
    draws = JaxDraws(cfg, jax.random.PRNGKey(0), data[0].shape[0])
    params, (J, acc) = mnist.train(
        mnist.MnistDiffusionConfig(Nsample=16, Ndiffuse=11),
        torch.Generator(), data=data, params=_to_torch(draws.params),
        draws=draws)
    np.testing.assert_allclose(J.numpy(), np.asarray(ref_J), rtol=0,
                               atol=J_ATOL)
    # the same count of test rows right at every step (the two means of
    # it may round one ulp apart)
    n_test = data[2].shape[0]
    np.testing.assert_array_equal(np.rint(acc.numpy() * n_test),
                                  np.rint(np.asarray(ref_acc) * n_test))
    for (W, b), (rW, rb) in zip(params, ref_params):
        np.testing.assert_allclose(W.numpy(), np.asarray(rW), rtol=0,
                                   atol=PARAM_ATOL)
        np.testing.assert_allclose(b.numpy(), np.asarray(rb), rtol=0,
                                   atol=PARAM_ATOL)


def test_train_draws_on_its_generator(data):
    """Without draws, two runs from one seed agree, and the population
    learns: the test accuracy after 20 steps beats chance."""
    cfg = mnist.MnistDiffusionConfig(Nsample=16, Ndiffuse=21)
    runs = [mnist.train(cfg, torch.Generator().manual_seed(3), data=data)
            for _ in range(2)]
    assert torch.equal(runs[0][1][0], runs[1][1][0])
    assert float(runs[0][1][1][-1]) > 0.3


def reference(seeds=range(6)):
    """JAX's published-config run of each seed on the CPU."""
    cfg = jmnist.MnistDiffusionConfig()
    data = jmnist.load_dataset()
    rows = []
    for seed in seeds:
        t0 = time.perf_counter()
        _, (J, acc) = jmnist.train(cfg, jax.random.PRNGKey(seed), data=data)
        rows.append(dict(seed=seed, test_acc=float(acc[-1]),
                         J_final=float(J[-1])))
        print(rows[-1], f"{time.perf_counter() - t0:.1f} s", flush=True)
    accs = np.array([r["test_acc"] for r in rows])
    out = dict(source="PYTHONPATH=. python tests/test_torch_mnist.py "
                      "--reference (mbd_tpu.blackbox.mnist.train on JAX's "
                      "CPU backend)",
               Nsample=cfg.Nsample, Ndiffuse=cfg.Ndiffuse,
               dataset="the committed sklearn digits (assets/digits.npz)",
               seeds=rows, test_acc_mean=float(accs.mean()),
               test_acc_std=float(accs.std()))
    with open(REFERENCE, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {REFERENCE}: mean {accs.mean():.6f} ± {accs.std():.6f}")


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    if "--reference" in sys.argv:
        reference()
