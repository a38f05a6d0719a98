"""Environment registry (port of ``mbd_tpu/envs/__init__.py``)."""

from ..device import DEFAULT
from .base import Env, State  # noqa: F401


def get_env(env_name: str, device=DEFAULT):
    if env_name == "hopper":
        from .hopper import Hopper
        return Hopper(device)
    if env_name == "walker2d":
        from .walker2d import Walker2d
        return Walker2d(device)
    if env_name == "halfcheetah":
        from .halfcheetah import Halfcheetah
        return Halfcheetah(device)
    if env_name == "cartpole":
        from .cartpole import Cartpole
        return Cartpole(device)
    if env_name == "ant":
        from .ant import Ant
        return Ant(device)
    if env_name == "humanoidrun":
        from .humanoidrun import HumanoidRun
        return HumanoidRun(device)
    if env_name == "humanoidstandup":
        from .humanoidstandup import HumanoidStandup
        return HumanoidStandup(device)
    if env_name in ("humanoidtrack", "humanoidtrack_walk"):
        from .humanoidtrack import HumanoidTrack
        return HumanoidTrack("walk" if env_name.endswith("_walk") else "jog",
                             device)
    if env_name == "pushT":
        from .pushT import PushT
        return PushT(device)
    raise NotImplementedError(
        f"environment {env_name!r} is not ported to mbd_tpu_torch yet "
        "(see ROADMAP.md, Queue 1 item 2)")
