"""In-repo MinAtar-style environments (Atari-class proxy); a numpy copy of
``ray_tpu/rllib/envs.py``.

The reference validates IMPALA on ALE Atari
(``rllib/tuned_examples/impala/atari-impala-large.yaml``); this image has
no ALE, so the throughput/learning proxy is a MinAtar-shaped Breakout
(Young & Tian, 2019 style: small grid, channel-stacked binary planes,
dense-ish reward) implemented here with the gymnasium API surface the
rollout workers use. ``make_env`` resolves these names and falls back to
``gymnasium.make`` for everything else (gymnasium is imported only then, so
the in-repo envs need none).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


class _DiscreteSpace:
    def __init__(self, n: int):
        self.n = n


class _BoxSpace:
    def __init__(self, shape: Tuple[int, ...]):
        self.shape = shape


class MinAtarBreakout:
    """10x10 Breakout on three binary channels (paddle, ball, bricks).

    Actions: 0 = left, 1 = stay, 2 = right. Reward +1 per brick. The
    episode terminates when the ball passes the paddle; clearing the wall
    re-racks the bricks (episodes can run long for a good policy)."""

    SIZE = 10
    BRICK_ROWS = 3

    def __init__(self, max_steps: int = 1000):
        self.max_steps = max_steps
        self.action_space = _DiscreteSpace(3)
        self.observation_space = _BoxSpace((3 * self.SIZE * self.SIZE,))
        self._rng = np.random.default_rng(0)
        self._steps = 0

    # -- gym API --

    def reset(self, *, seed: Optional[int] = None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        n = self.SIZE
        self.paddle = n // 2
        self.ball_x = int(self._rng.integers(1, n - 1))
        self.ball_y = self.BRICK_ROWS + 1
        self.dx = int(self._rng.choice([-1, 1]))
        self.dy = 1
        self.bricks = np.ones((self.BRICK_ROWS, n), np.bool_)
        self._steps = 0
        return self._obs(), {}

    def step(self, action: int):
        n = self.SIZE
        self._steps += 1
        self.paddle = int(np.clip(self.paddle + (int(action) - 1), 0, n - 1))
        reward = 0.0
        # ball motion with wall bounces
        nx = self.ball_x + self.dx
        if nx < 0 or nx >= n:
            self.dx = -self.dx
            nx = self.ball_x + self.dx
        ny = self.ball_y + self.dy
        if ny < 0:
            self.dy = -self.dy
            ny = self.ball_y + self.dy
        # brick hit
        if 0 <= ny < self.BRICK_ROWS and self.bricks[ny, nx]:
            self.bricks[ny, nx] = False
            reward += 1.0
            self.dy = -self.dy
            ny = self.ball_y + self.dy
            ny = max(0, min(n - 1, ny))
        terminated = False
        if ny == n - 1:
            if abs(nx - self.paddle) <= 1:  # 3-cell paddle
                self.dy = -1
                ny = n - 2
                # paddle english: ball follows the paddle's last move a bit
                if int(action) != 1:
                    self.dx = int(action) - 1 or self.dx
            else:
                terminated = True
        self.ball_x, self.ball_y = nx, ny
        if not self.bricks.any():
            self.bricks[:] = True  # re-rack; keep the episode going
        truncated = self._steps >= self.max_steps
        return self._obs(), reward, terminated, truncated, {}

    def _obs(self) -> np.ndarray:
        n = self.SIZE
        planes = np.zeros((3, n, n), np.float32)
        lo = max(0, self.paddle - 1)
        hi = min(n, self.paddle + 2)
        planes[0, n - 1, lo:hi] = 1.0
        planes[1, self.ball_y, self.ball_x] = 1.0
        planes[2, : self.BRICK_ROWS] = self.bricks
        return planes.reshape(-1)

    def close(self):
        pass


_REGISTRY = {
    "MinAtar-Breakout": MinAtarBreakout,
}


def make_env(name: str, **kw):
    """Resolve in-repo envs by name; everything else via gymnasium."""
    ctor = _REGISTRY.get(name)
    if ctor is not None:
        return ctor(**kw)
    import gymnasium

    return gymnasium.make(name, **kw)
