"""The port's RL networks and trainers (``mbd_tpu_torch/rl/``) against the
JAX package's (``mbd_tpu/rl/``) on the same inputs.

JAX draws with threefry and torch with Philox, so every draw is passed in:
the port's noise arguments (``networks.Draws``) take JAX's draws, and the
params start from JAX's init, carried across with ``networks.load_tree``.
JAX's SAC losses and PPO's GAE and loss are closures inside its
``train``; they are rebuilt here from ``mbd_tpu.rl.networks`` line for
line, and one PPO iteration runs through JAX's real ``ppo.train``.

Tolerances: forward passes and single losses at 1e-6 (float32 through the
same layers, summed in other orders); after optimizer steps, params at
rtol 1e-4 (torch's Adam and optax's differ only in rounding).

``PYTHONPATH=. python tests/test_torch_rl.py --convert`` rewrites
``mbd_tpu_torch/assets/hopper_sac.npz`` from ``results/hopper/
params.msgpack``: the params, JAX's eval resets (``env.reset(PRNGKey(s))``,
s = 0–7) and JAX's per-seed eval rewards by ``mbd_tpu/rl/train.py``'s
protocol on the CPU (8 seeds × 50 steps, deterministic actions).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from mbd_tpu import envs as jax_envs
from mbd_tpu.rl import networks as jnet
from mbd_tpu.rl import ppo as jppo
from mbd_tpu_torch import envs
from mbd_tpu_torch.rl import networks, ppo, sac, train

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MSGPACK = os.path.join(ROOT, "results", "hopper", "params.msgpack")


def t(x):
    return torch.tensor(np.asarray(x))


def carry(net_j, net_t, *dummies, key=0):
    """Init the flax net from PRNGKey(key) and copy it into the port's."""
    p = net_j.init(jax.random.PRNGKey(key), *dummies)
    networks.load_net_tree(net_t, jax.tree.map(np.asarray, p))
    return p


def grad_tree(net):
    """A network's gradients in flax's tree of its params."""
    return {"params": {
        f"MLP_{i}": {f"Dense_{k}": {"kernel": lin.weight.grad.numpy().T,
                                    "bias": lin.bias.grad.numpy()}
                     for k, lin in enumerate(mlp.layers)}
        for i, mlp in enumerate(net.mlps)}}


# --- networks ----------------------------------------------------------------

def test_forward_passes_from_carried_params():
    """Policy (32)×4, value (256)×5 and the twin Q (256, 256) on the same
    observations from the same params, at 1e-6."""
    rng = np.random.default_rng(0)
    obs = rng.normal(size=(7, 12)).astype(np.float32)
    act = rng.uniform(-1, 1, size=(7, 3)).astype(np.float32)
    pol_t = networks.PolicyNet(12, 3)
    pol_j = carry(jnet.PolicyNet(action_size=3), pol_t, jnp.zeros(12))
    mu, ls = jnet.PolicyNet(action_size=3).apply(pol_j, obs)
    mu_t, ls_t = pol_t(t(obs))
    np.testing.assert_allclose(mu_t.detach(), mu, rtol=0, atol=1e-6)
    np.testing.assert_allclose(ls_t.detach(), ls, rtol=0, atol=1e-6)
    val_t = networks.ValueNet(12)
    val_j = carry(jnet.ValueNet(), val_t, jnp.zeros(12), key=1)
    np.testing.assert_allclose(val_t(t(obs)).detach(),
                               jnet.ValueNet().apply(val_j, obs), rtol=0,
                               atol=1e-6)
    q_t = networks.QNet(12, 3)
    q_j = carry(jnet.QNet(), q_t, jnp.zeros(12), jnp.zeros(3), key=2)
    for a, b in zip(q_t(t(obs), t(act)), jnet.QNet().apply(q_j, obs, act)):
        np.testing.assert_allclose(a.detach(), b, rtol=0, atol=1e-6)


def test_init_is_lecun_uniform_with_zero_biases():
    """flax's lecun_uniform: U(±√(3/fan_in)), variance 1/fan_in; biases 0.
    Checked by bounds and variance (the streams differ)."""
    net = networks.ValueNet(12, generator=torch.Generator().manual_seed(0))
    for lin in net.mlps[0].layers:
        w = lin.weight.detach()
        lim = (3.0 / lin.in_features) ** 0.5
        assert float(w.abs().max()) <= lim
        if w.numel() >= 4096:
            assert abs(float(w.var()) * lin.in_features - 1.0) < 0.05
        assert not lin.bias.detach().any()


def test_tanh_normal_with_jax_draws():
    """sample_action, log_prob, entropy_estimate and deterministic_action
    on JAX's own normal draws, at 1e-6 (log σ clipped to [−5, 2] on both
    ends: the inputs pass both clips)."""
    rng = np.random.default_rng(1)
    mu = rng.normal(size=(64, 3)).astype(np.float32) * 2
    ls = rng.uniform(-7, 4, size=(64, 3)).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(3), 64)
    noise = np.stack([np.asarray(jax.random.normal(k, (3,))) for k in keys])
    act, logp, pre = jax.vmap(jnet.sample_action)(mu, ls, keys)
    a_t, l_t, p_t = networks.sample_action(t(mu), t(ls), t(noise))
    np.testing.assert_allclose(p_t, pre, rtol=0, atol=1e-6)
    np.testing.assert_allclose(a_t, act, rtol=0, atol=1e-6)
    np.testing.assert_allclose(l_t, logp, rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(networks.log_prob(t(mu), t(ls), t(pre)),
                               jnet.log_prob(mu, ls, pre), rtol=1e-6,
                               atol=1e-5)
    ent = jax.vmap(jnet.entropy_estimate)(mu, ls, keys)
    np.testing.assert_allclose(
        networks.entropy_estimate(t(mu), t(ls), t(noise)), ent, rtol=1e-6,
        atol=1e-5)
    np.testing.assert_allclose(
        networks.deterministic_action(t(mu), t(ls)),
        jnet.deterministic_action(mu, ls), rtol=0, atol=1e-6)


def test_running_stats_matches_jax():
    """Chan's merge over five uneven chunks with leading [T, B] axes."""
    rng = np.random.default_rng(2)
    rs_j = jnet.RunningStats.create(4)
    rs_t = networks.RunningStats.create(4, "cpu")
    for n in (3, 7, 1, 12, 5):
        chunk = rng.normal(2.0, 3.0, size=(n, 2, 4)).astype(np.float32)
        rs_j, rs_t = rs_j.update(jnp.asarray(chunk)), rs_t.update(t(chunk))
    for k in ("count", "mean", "m2"):
        np.testing.assert_allclose(getattr(rs_t, k), getattr(rs_j, k),
                                   rtol=1e-6)
    obs = rng.normal(size=(5, 4)).astype(np.float32)
    np.testing.assert_allclose(rs_t.normalize(t(obs)),
                               rs_j.normalize(jnp.asarray(obs)), rtol=1e-5,
                               atol=1e-6)


def test_params_tree_is_flax_tree(tmp_path):
    """``to_tree`` of SAC's params has the key paths and shapes that flax
    serialises for JAX's SACParams; ``save_npz`` / ``load_npz`` /
    ``load_tree`` carry it back bit for bit."""
    from flax import serialization

    env = envs.get_env("hopper", device="cpu")
    params = sac.init_params(env, 0)
    tree = networks.to_tree(params)
    with open(MSGPACK, "rb") as f:
        ref = serialization.msgpack_restore(f.read())
    flat, flat_ref = networks.flatten(tree), networks.flatten(ref)
    assert sorted(flat) == sorted(flat_ref)
    for k in flat:
        assert flat[k].shape == np.asarray(flat_ref[k]).shape, k
    path = str(tmp_path / "p.npz")
    networks.save_npz(path, tree)
    other = sac.init_params(env, 1)
    networks.load_tree(other, networks.load_npz(path))
    for k, v in networks.flatten(networks.to_tree(other)).items():
        np.testing.assert_array_equal(v, flat[k])


# --- PPO -------------------------------------------------------------------

def jax_gae(cfg, v, v_next, data):
    """JAX's compute_gae (mbd_tpu/rl/ppo.py:174-198) after the value
    passes, line for line."""
    termination = data["done"] * (1.0 - data["truncation"])

    def body(gae, xs):
        delta, term, trunc = xs
        gae = delta + cfg.discounting * cfg.gae_lambda * (1.0 - term) * gae
        gae = gae * (1.0 - trunc)
        return gae, gae

    delta = data["reward"] + cfg.discounting * v_next * (1.0 - termination) \
        - v
    _, adv = jax.lax.scan(body, jnp.zeros_like(delta[0]),
                          (delta[::-1], termination[::-1],
                           data["truncation"][::-1]))
    adv = adv[::-1]
    returns = adv + v
    return (adv - adv.mean()) / (adv.std() + 1e-8), returns


def test_gae_matches_jax():
    """Advantages and returns over T = 9 steps with terminations and
    truncations, at 1e-5."""
    rng = np.random.default_rng(3)
    T, B = 9, 16
    data = dict(reward=rng.normal(size=(T, B)).astype(np.float32),
                done=(rng.uniform(size=(T, B)) < 0.2).astype(np.float32))
    data["truncation"] = data["done"] * (rng.uniform(size=(T, B)) < 0.5)
    v = rng.normal(size=(T, B)).astype(np.float32)
    v_next = rng.normal(size=(T, B)).astype(np.float32)
    cfg = ppo.PPOConfig()
    adv_j, ret_j = jax_gae(cfg, v, v_next, {k: jnp.asarray(x)
                                            for k, x in data.items()})
    adv_t, ret_t = ppo.compute_gae(cfg, t(v), t(v_next),
                                   {k: t(x) for k, x in data.items()})
    np.testing.assert_allclose(adv_t, adv_j, rtol=0, atol=1e-5)
    np.testing.assert_allclose(ret_t, ret_j, rtol=0, atol=1e-5)


def test_ppo_loss_and_grads_match_jax():
    """JAX's loss_fn (mbd_tpu/rl/ppo.py:201-220) rebuilt from its networks:
    the loss, its parts and every gradient from the same params, batch and
    entropy draws."""
    rng = np.random.default_rng(4)
    cfg = ppo.PPOConfig()
    n, obs_size, nu = 32, 5, 2
    pol_t, val_t = networks.PolicyNet(obs_size, nu), networks.ValueNet(
        obs_size)
    pol_net, val_net = jnet.PolicyNet(action_size=nu), jnet.ValueNet()
    pol_j = carry(pol_net, pol_t, jnp.zeros(obs_size))
    val_j = carry(val_net, val_t, jnp.zeros(obs_size), key=1)
    batch = dict(obs=rng.normal(size=(n, obs_size)),
                 pre=rng.normal(size=(n, nu)), logp=rng.normal(size=n) - 2,
                 adv=rng.normal(size=n), returns=rng.normal(size=n))
    batch = {k: v.astype(np.float32) for k, v in batch.items()}
    key = jax.random.PRNGKey(5)
    noise = np.asarray(jax.random.normal(key, (n, nu)))

    def loss_j(nets):
        mu, ls = pol_net.apply(nets[0], batch["obs"])
        logp = jnet.log_prob(mu, ls, batch["pre"])
        ratio = jnp.exp(logp - batch["logp"])
        surr1 = ratio * batch["adv"]
        surr2 = jnp.clip(ratio, 1.0 - cfg.clip_epsilon,
                         1.0 + cfg.clip_epsilon) * batch["adv"]
        policy_loss = -jnp.mean(jnp.minimum(surr1, surr2))
        v = val_net.apply(nets[1], batch["obs"])
        value_loss = 0.5 * jnp.mean((batch["returns"] - v) ** 2)
        ent = jnet.entropy_estimate(mu, ls, key).mean()
        return policy_loss + value_loss - cfg.entropy_cost * ent, (
            policy_loss, value_loss, ent)

    (total, parts), grads = jax.value_and_grad(loss_j, has_aux=True)(
        (pol_j, val_j))
    params = ppo.PPOParams(pol_t, val_t, None)
    total_t, metrics = ppo.loss_fn(cfg, params, {k: t(v) for k, v in
                                                 batch.items()}, t(noise),
                                   lambda o: o)
    total_t.backward()
    np.testing.assert_allclose(float(total_t.detach()), float(total),
                               rtol=1e-6)
    for name, ref in zip(("policy_loss", "value_loss", "entropy"), parts):
        np.testing.assert_allclose(float(metrics[name].detach()),
                                   float(ref), rtol=1e-5)
    for net_t, g in zip((pol_t, val_t), grads):
        got = networks.flatten(grad_tree(net_t))
        for k, v in networks.flatten(jax.tree.map(np.asarray, g)).items():
            np.testing.assert_allclose(got[k], v, rtol=1e-4, atol=1e-6,
                                       err_msg=k)


class ReplayedDraws:
    """The port's draws taken from queues of JAX's."""

    def __init__(self, generator, **queues):
        self.generator = generator
        self.queues = {k: list(v) for k, v in queues.items()}

    def _pop(self, kind):
        return torch.tensor(np.asarray(self.queues[kind].pop(0)))

    def action(self, shape):
        return self._pop("action")

    def entropy(self, shape):
        return self._pop("entropy")

    def critic(self, shape):
        return self._pop("critic")

    def actor(self, shape):
        return self._pop("actor")

    def permutation(self, n):
        return self._pop("permutation").long()

    def indices(self, high, n):
        return self._pop("indices").long()


def ppo_key_schedule(cfg, nu):
    """JAX ppo.train's draws for one iteration (mbd_tpu/rl/ppo.py:129-266):
    the action noise of each unroll step, each epoch's permutation and each
    minibatch's entropy noise, in the order the port asks for them."""
    rng = jax.random.PRNGKey(cfg.seed)
    rng, _, _, _ = jax.random.split(rng, 4)
    rng, k_roll, k_perm, _ = jax.random.split(rng, 4)
    actions = []
    for _ in range(cfg.unroll_length):
        k_roll, k_act = jax.random.split(k_roll)
        keys = jax.random.split(k_act, cfg.num_envs)
        actions.append(np.stack([np.asarray(jax.random.normal(k, (nu,)))
                                 for k in keys]))
    n = cfg.unroll_length * cfg.num_envs
    mb = n // cfg.num_minibatches
    perms, ents = [], []
    for _ in range(cfg.num_updates_per_batch):
        k_perm, k_shuf, _ = jax.random.split(k_perm, 3)
        perms.append(np.asarray(jax.random.permutation(k_shuf, n)))
        for _ in range(cfg.num_minibatches):
            k_perm, k = jax.random.split(k_perm)
            ents.append(np.asarray(jax.random.normal(k, (mb, nu))))
    return dict(action=actions, permutation=perms, entropy=ents)


def test_one_ppo_iteration_matches_jax_train():
    """One iteration of JAX's real ``ppo.train`` on car2d (16 envs, unroll
    5, 2 minibatches, 2 epochs) against the port's, teacher-forced: the
    same initial params (JAX's, carried), the same resets (car2d's are
    fixed) and JAX's draws replayed into the port's. The final params: at
    rtol 1e-4 (atol 1e-6) all but 0.2 % of each array's entries (or one),
    and every entry
    within half an Adam step (lr = 3e-4). Adam moves an entry by about lr
    whatever its gradient's size, so where a gradient is near 0 its
    rounding shows at the step's scale: of the value net's 256 × 256
    layers, up to 75 entries in 65 536 (0.11 %) came out beyond rtol 1e-4,
    the farthest 0.149 lr off, and one of 256 biases 1.6e-6 off at 8.6e-5.
    Then the eval returns.
    """
    cfg = ppo.PPOConfig(num_timesteps=80, num_evals=1, episode_length=3,
                        num_envs=16, unroll_length=5, num_minibatches=2,
                        num_updates_per_batch=2, num_eval_envs=4, seed=0)
    jcfg = jppo.PPOConfig(**cfg.__dict__)
    jenv = jax_envs.get_env("car2d")
    env = envs.get_env("car2d", device="cpu")
    _, jparams, jhist = jppo.train(jenv, jcfg)

    rng = jax.random.PRNGKey(cfg.seed)
    _, k_p, k_v, _ = jax.random.split(rng, 4)
    dummy = jnp.zeros((env.observation_size,))
    params = ppo.init_params(env, 0)
    networks.load_net_tree(params.policy, jax.tree.map(
        np.asarray, jnet.PolicyNet(action_size=2).init(k_p, dummy)))
    networks.load_net_tree(params.value, jax.tree.map(
        np.asarray, jnet.ValueNet().init(k_v, dummy)))
    draws = ReplayedDraws(torch.Generator(), **ppo_key_schedule(cfg, 2))
    _, params, hist = ppo.train(env, cfg, params=params, draws=draws)
    assert hist[0]["num_steps"] == jhist[0]["num_steps"] == 80
    got = networks.flatten(networks.to_tree(params))
    want = networks.flatten(jax.tree.map(np.asarray, {
        "policy": jparams.policy, "value": jparams.value,
        "obs_stats": {"count": jparams.obs_stats.count,
                      "mean": jparams.obs_stats.mean,
                      "m2": jparams.obs_stats.m2}}))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        off = ~np.isclose(got[k], v, rtol=1e-4, atol=1e-6)
        assert off.sum() <= max(1, 2e-3 * off.size), (k, int(off.sum()))
        np.testing.assert_allclose(got[k], v, rtol=0,
                                   atol=0.5 * cfg.learning_rate, err_msg=k)
    np.testing.assert_allclose(hist[0]["eval/episode_reward"],
                               jhist[0]["eval/episode_reward"], atol=1e-5)


# --- SAC -------------------------------------------------------------------

def jax_sac_closures(cfg, act_size):
    """JAX's critic_loss, actor_loss, alpha_loss and sgd_step
    (mbd_tpu/rl/sac.py:120-184) rebuilt from its networks, line for line,
    with each draw's key and the batch passed in."""
    policy_net = jnet.PolicyNet(action_size=act_size, hidden=(256, 256))
    q_net = jnet.QNet()
    target_entropy = -0.5 * act_size
    opt = optax.adam(cfg.learning_rate)

    def critic_loss(q_params, params, batch, rng):
        mu, ls = policy_net.apply(params["policy"], batch["next_obs"])
        next_act, next_logp, _ = jnet.sample_action(mu, ls, rng)
        q1t, q2t = q_net.apply(params["q_target"], batch["next_obs"],
                               next_act)
        alpha = jnp.exp(params["log_alpha"])
        target = batch["reward"] + cfg.discounting * batch["discount"] * (
            jnp.minimum(q1t, q2t) - alpha * next_logp)
        q1, q2 = q_net.apply(q_params, batch["obs"], batch["act"])
        target = jax.lax.stop_gradient(target)
        return 0.5 * ((q1 - target) ** 2 + (q2 - target) ** 2).mean()

    def actor_loss(policy_params, params, batch, rng):
        mu, ls = policy_net.apply(policy_params, batch["obs"])
        act, logp, _ = jnet.sample_action(mu, ls, rng)
        q1, q2 = q_net.apply(params["q"], batch["obs"], act)
        alpha = jnp.exp(params["log_alpha"])
        return (alpha * logp - jnp.minimum(q1, q2)).mean(), logp

    def alpha_loss(log_alpha, logp):
        return (-jnp.exp(log_alpha) *
                jax.lax.stop_gradient(logp + target_entropy)).mean()

    def sgd_step(params, opt_states, batch, k_c, k_a):
        qg = jax.grad(critic_loss)(params["q"], params, batch, k_c)
        up, qs = opt.update(qg, opt_states[1], params["q"])
        params = dict(params, q=optax.apply_updates(params["q"], up))
        pg, logp = jax.grad(actor_loss, has_aux=True)(
            params["policy"], params, batch, k_a)
        up, ps = opt.update(pg, opt_states[0], params["policy"])
        params = dict(params, policy=optax.apply_updates(params["policy"],
                                                         up))
        ag = jax.grad(alpha_loss)(params["log_alpha"], logp)
        up, as_ = opt.update(ag, opt_states[2], params["log_alpha"])
        params = dict(params, log_alpha=optax.apply_updates(
            params["log_alpha"], up), q_target=jax.tree.map(
            lambda t_, o: t_ * (1 - cfg.tau) + o * cfg.tau,
            params["q_target"], params["q"]))
        return params, (ps, qs, as_)

    return policy_net, q_net, opt, critic_loss, actor_loss, alpha_loss, \
        sgd_step


def _sac_setup(n=64):
    rng = np.random.default_rng(6)
    obs_size, nu = 11, 3
    cfg = sac.SACConfig(normalize_observations=False)
    pol_t = networks.PolicyNet(obs_size, nu, hidden=(256, 256))
    q_t, qt_t = networks.QNet(obs_size, nu), networks.QNet(obs_size, nu)
    policy_net, q_net, opt, *fns = jax_sac_closures(cfg, nu)
    jparams = dict(
        policy=carry(policy_net, pol_t, jnp.zeros(obs_size)),
        q=carry(q_net, q_t, jnp.zeros(obs_size), jnp.zeros(nu), key=1),
        q_target=carry(q_net, qt_t, jnp.zeros(obs_size), jnp.zeros(nu),
                       key=2),
        log_alpha=jnp.asarray(0.3, jnp.float32))
    params = sac.SACParams(
        policy=pol_t, q=q_t, q_target=qt_t.requires_grad_(False),
        log_alpha=torch.tensor(0.3, requires_grad=True), obs_stats=None)
    batch = dict(obs=rng.normal(size=(n, obs_size)),
                 act=rng.uniform(-1, 1, size=(n, nu)),
                 reward=rng.normal(size=n),
                 next_obs=rng.normal(size=(n, obs_size)),
                 discount=(rng.uniform(size=n) < 0.9).astype(float))
    batch = {k: v.astype(np.float32) for k, v in batch.items()}
    keys = jax.random.split(jax.random.PRNGKey(7), 2)
    noise = [t(jax.random.normal(k, (n, nu))) for k in keys]
    return cfg, params, jparams, batch, keys, noise, opt, fns


def test_sac_losses_match_jax():
    """The critic, actor and α losses from the same params, batch and
    draws, at 1e-6 relative."""
    cfg, params, jparams, batch, keys, noise, _, fns = _sac_setup()
    critic_loss, actor_loss, alpha_loss, _ = fns
    learner = sac.Learner(cfg, params, 3)
    tb = {k: t(v) for k, v in batch.items()}
    np.testing.assert_allclose(
        float(learner.critic_loss(tb, noise[0])),
        float(critic_loss(jparams["q"], jparams, batch, keys[0])),
        rtol=1e-6)
    a_t, logp_t = learner.actor_loss(tb, noise[1])
    a_j, logp_j = actor_loss(jparams["policy"], jparams, batch, keys[1])
    np.testing.assert_allclose(float(a_t), float(a_j), rtol=1e-6)
    np.testing.assert_allclose(logp_t.detach(), logp_j, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(learner.alpha_loss(logp_t)),
                               float(alpha_loss(jparams["log_alpha"],
                                                logp_j)), rtol=1e-6)


def test_sac_sgd_step_matches_jax():
    """Two SGD steps (critic, actor, α, target, in JAX's order) from the
    same params, batch and draws: every param at rtol 1e-4."""
    cfg, params, jparams, batch, keys, noise, opt, fns = _sac_setup()
    sgd_step = fns[-1]
    learner = sac.Learner(cfg, params, 3)
    tb = {k: t(v) for k, v in batch.items()}
    opt_states = (opt.init(jparams["policy"]), opt.init(jparams["q"]),
                  opt.init(jparams["log_alpha"]))
    for _ in range(2):
        jparams, opt_states = sgd_step(jparams, opt_states, batch, *keys)
        learner.sgd_step(tb, *noise)
    got = networks.flatten({"policy": networks.net_tree(params.policy),
                            "q": networks.net_tree(params.q),
                            "q_target": networks.net_tree(params.q_target),
                            "log_alpha": params.log_alpha.detach().numpy()})
    for k, v in networks.flatten(jax.tree.map(np.asarray, jparams)).items():
        np.testing.assert_allclose(got[k], v, rtol=1e-4, atol=1e-6,
                                   err_msg=k)


def test_replay_insert_wraps_and_samples_as_jax():
    """Inserts of 5, 5 and 4 rows into a buffer of 8 (the last two wrap)
    and a sample at given indices, against JAX's Replay."""
    from mbd_tpu.rl.sac import Replay as JReplay

    rng = np.random.default_rng(8)
    jr = JReplay.create(8, 3, 2)
    tr = sac.Replay(8, 3, 2, "cpu")
    for n in (5, 5, 4):
        rows = dict(obs=rng.normal(size=(n, 3)), act=rng.normal(size=(n, 2)),
                    reward=rng.normal(size=n),
                    next_obs=rng.normal(size=(n, 3)),
                    discount=rng.uniform(size=n))
        rows = {k: v.astype(np.float32) for k, v in rows.items()}
        jr = jr.insert(*(jnp.asarray(rows[k]) for k in sac.Replay.FIELDS))
        tr.insert(*(t(rows[k]) for k in sac.Replay.FIELDS))
        assert (tr.pos, tr.size) == (int(jr.pos), int(jr.size))
    idx = np.array([0, 7, 3, 3, 5])
    for k in sac.Replay.FIELDS:
        np.testing.assert_array_equal(getattr(tr, k), getattr(jr, k))
        np.testing.assert_array_equal(tr.sample(t(idx))[k],
                                      np.asarray(getattr(jr, k))[idx])


# --- JAX's trained hopper policy ---------------------------------------------

def _jax_policy(tree):
    """JAX's deterministic SAC inference for a restored params tree (as
    mbd_tpu/rl/sac.py's make_inference_fn)."""
    net = jnet.PolicyNet(action_size=3, hidden=(256, 256))
    stats = jnet.RunningStats(**{k: jnp.asarray(v) for k, v in
                                 tree["obs_stats"].items()})

    def inference(obs):
        mu, ls = net.apply(tree["policy"], stats.normalize(obs))
        return jnet.deterministic_action(mu, ls)
    return jax.jit(inference)


def convert():
    """Write ``mbd_tpu_torch/assets/hopper_sac.npz`` (module docstring)."""
    from flax import serialization

    from mbd_tpu.rl.wrappers import DivergenceGuardWrapper

    with open(MSGPACK, "rb") as f:
        tree = jax.tree.map(np.asarray,
                            serialization.msgpack_restore(f.read()))
    env = DivergenceGuardWrapper(jax_envs.get_env("hopper"))
    inference, step = _jax_policy(tree), jax.jit(env.step)
    qs, qds, rews = [], [], []
    for seed in range(train.N_EVAL_SEEDS):
        state = env.reset(jax.random.PRNGKey(seed))
        qs.append(np.asarray(state.pipeline_state.q))
        qds.append(np.asarray(state.pipeline_state.qd))
        ep = []
        for _ in range(train.eval_steps("hopper")):
            state = step(state, inference(state.obs))
            ep.append(float(state.reward))
        rews.append(np.mean(ep))
    tree["eval"] = dict(q=np.stack(qs), qd=np.stack(qds),
                        rewards=np.asarray(rews, np.float64))
    networks.save_npz(train.HOPPER_SAC, tree)
    print(f"wrote {train.HOPPER_SAC}: JAX's eval (CPU) {np.mean(rews):.4f} "
          f"± {np.std(rews):.4f} ({[round(r, 4) for r in rews]})")


def test_hopper_asset_is_the_msgpack():
    """The committed asset's params equal a fresh decode of JAX's
    checkpoint, and its resets JAX's ``env.reset(PRNGKey(s))``."""
    from flax import serialization

    with open(MSGPACK, "rb") as f:
        ref = networks.flatten(jax.tree.map(
            np.asarray, serialization.msgpack_restore(f.read())))
    got = networks.flatten(networks.load_npz(train.HOPPER_SAC))
    assert sorted(k for k in got if not k.startswith("eval/")) == sorted(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    env = jax_envs.get_env("hopper")
    for s in (0, 7):
        ps = env.reset(jax.random.PRNGKey(s)).pipeline_state
        np.testing.assert_array_equal(got["eval/q"][s], ps.q)
        np.testing.assert_array_equal(got["eval/qd"][s], ps.qd)


def test_hopper_policy_first_eval_step_matches_jax():
    """JAX's trained policy in the port, from JAX's seed-0 reset: the
    observation, the action and the step's reward of the port's CPU eval
    (``train.evaluate_seeds``) against JAX's (``DivergenceGuardWrapper``
    over the env's own step), at 1e-5."""
    from mbd_tpu.rl.wrappers import DivergenceGuardWrapper

    tree = networks.load_npz(train.HOPPER_SAC)
    env = envs.get_env("hopper", device="cpu")
    params = sac.init_params(env, 0)
    networks.load_tree(params, tree)
    cfg = sac.SACConfig(**train.SAC_CONFIGS["hopper"])
    policy = networks.make_inference_fn(cfg, params)
    q0, qd0 = t(tree["eval"]["q"][:1].T), t(tree["eval"]["qd"][:1].T)
    obs_t = env.obs_qs_b(q0, qd0).t()
    act_t = policy(obs_t)
    rew_t, _ = train.evaluate_seeds(env, policy, q0, qd0, 1)

    jenv = DivergenceGuardWrapper(jax_envs.get_env("hopper"))
    state = jenv.reset(jax.random.PRNGKey(0))
    act_j = _jax_policy(tree)(state.obs)
    nxt = jax.jit(jenv.step)(state, act_j)
    np.testing.assert_allclose(obs_t[0], state.obs, rtol=0, atol=1e-5)
    np.testing.assert_allclose(act_t[0], act_j, rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(rew_t[0]), float(nxt.reward), atol=1e-5)


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    if "--convert" in sys.argv:
        convert()
